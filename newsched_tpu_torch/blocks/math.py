"""Math blocks (reference: newsched_tpu/blocks/math.py): add, multiply,
add_const, multiply_const, conjugate, the type-converting complex_to_*
family, float_to_complex and abs. All elementwise tensor ops."""

from __future__ import annotations

import torch

from newsched_tpu_torch.runtime.block import SyncBlock
from newsched_tpu_torch.utils.dtypes import port_dtype


class _elementwise_nary(SyncBlock):
    def __init__(self, nports: int, dtype, name=None):
        super().__init__(name)
        self.nports = nports
        for k in range(nports):
            self.add_input(f"in{k}", dtype)
        self.add_output("out", dtype)


class add(_elementwise_nary):
    """out = sum(inputs) (reference math::add<T>)."""

    def __init__(self, nports: int = 2, dtype="cf32", name=None):
        super().__init__(nports, dtype, name)

    def work(self, state, ins, params, nout):
        acc = ins["in0"]
        for k in range(1, self.nports):
            acc = acc + ins[f"in{k}"]
        return state, {"out": acc}


class multiply(_elementwise_nary):
    """out = prod(inputs) (reference math::multiply<T>)."""

    def __init__(self, nports: int = 2, dtype="cf32", name=None):
        super().__init__(nports, dtype, name)

    def work(self, state, ins, params, nout):
        acc = ins["in0"]
        for k in range(1, self.nports):
            acc = acc * ins[f"in{k}"]
        return state, {"out": acc}


class _const_op(SyncBlock):
    def __init__(self, k, dtype, name=None):
        super().__init__(name)
        d = port_dtype(dtype)
        self.add_input("in", d)
        self.add_output("out", d)
        self.declare_param("k", k, dtype=d.np_dtype, doc="constant operand")


class add_const(_const_op):
    """out = in + k; k settable at run time (reference math::add_const)."""

    def work(self, state, ins, params, nout):
        return state, {"out": ins["in"] + params["k"]}


class multiply_const(_const_op):
    """out = in * k (reference math::multiply_const)."""

    def work(self, state, ins, params, nout):
        return state, {"out": ins["in"] * params["k"]}


class _cf32_to_rf32(SyncBlock):
    def __init__(self, name=None):
        super().__init__(name)
        self.add_input("in", "cf32")
        self.add_output("out", "rf32")


class conjugate(SyncBlock):
    def __init__(self, name=None):
        super().__init__(name)
        self.add_input("in", "cf32")
        self.add_output("out", "cf32")

    def work(self, state, ins, params, nout):
        return state, {"out": torch.conj(ins["in"]).resolve_conj()}


class complex_to_mag(_cf32_to_rf32):
    def work(self, state, ins, params, nout):
        return state, {"out": ins["in"].abs().to(torch.float32)}


class complex_to_mag_squared(_cf32_to_rf32):
    def work(self, state, ins, params, nout):
        x = ins["in"]
        return state, {"out": (x.real ** 2 + x.imag ** 2).to(torch.float32)}


class complex_to_real(_cf32_to_rf32):
    def work(self, state, ins, params, nout):
        return state, {"out": ins["in"].real.to(torch.float32)}


class complex_to_imag(_cf32_to_rf32):
    def work(self, state, ins, params, nout):
        return state, {"out": ins["in"].imag.to(torch.float32)}


class float_to_complex(SyncBlock):
    def __init__(self, name=None):
        super().__init__(name)
        self.add_input("re", "rf32")
        self.add_input("im", "rf32")
        self.add_output("out", "cf32")

    def work(self, state, ins, params, nout):
        return state, {"out": torch.complex(ins["re"], ins["im"])}


class abs_blk(SyncBlock):
    """|x| for real streams (reference math::abs)."""

    def __init__(self, dtype="rf32", name=None):
        super().__init__(name)
        self.add_input("in", dtype)
        self.add_output("out", dtype)

    def work(self, state, ins, params, nout):
        return state, {"out": ins["in"].abs()}
