"""Define a block with a YAML descriptor at run time (the reference's
blockbuilder .yml, minus the codegen step) and render its GRC metadata
(reference: examples/yaml_block.py; the ``expr:`` written with torch).
``python3 -m newsched_tpu_torch.examples.yaml_block`` runs it on the card.
It needs PyYAML, which the card's machine lacks, so there it runs only
where PyYAML is installed; the tests run ``main("cpu")``.
"""

import numpy as np

from newsched_tpu_torch import Flowgraph
from newsched_tpu_torch.blocks import general
from newsched_tpu_torch.runtime.blockspec import block_from_yaml, grc_yaml

DESCRIPTOR = """
module: examples
block: db_scale
label: dB Scale
blocktype: sync_block
parameters:
  - id: ref
    label: Reference
    dtype: rf32
    default: 1.0
    settable: true
ports:
  - {domain: stream, id: in, direction: input, type: rf32}
  - {domain: stream, id: out, direction: output, type: rf32}
expr: "20 * torch.log10(torch.clamp(torch.abs(in_), min=1e-30) / ref)"
"""


def main(device="cuda"):
    db_scale = block_from_yaml(DESCRIPTOR)
    x = np.array([1.0, 0.1, 10.0, 0.5] * 64, np.float32)
    fg = Flowgraph(batch_size=64)
    src = general.vector_source(x, dtype="rf32")
    blk = db_scale(ref=1.0)
    snk = general.vector_sink(dtype="rf32")
    fg.connect(src, 0, blk, 0)
    fg.connect(blk, 0, snk, 0)
    fg.run(device=device)
    np.testing.assert_allclose(snk.data(), 20 * np.log10(np.abs(x)), atol=1e-4)
    print("block ran; GRC metadata:")
    print(grc_yaml(db_scale))


if __name__ == "__main__":
    main()
