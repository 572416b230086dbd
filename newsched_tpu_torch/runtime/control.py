"""Cross-process control plane for distributed flowgraphs (reference:
newsched_tpu/runtime/control.py; GNU Radio 4.0's runtime_proxy mirroring
param_change actions and msgport messages between processes).

One REP socket a partition, on the port's own ZMTP (``io/zmtp.py``):

    process B (runs partition "tail"):
        rt = Runtime(parts,
                     control_addresses={"tail": "tcp://127.0.0.1:5701"})
        rt.run()                # the control server starts with it

    process A (anyone holding the address):
        ctl = RuntimeClient("tcp://127.0.0.1:5701")
        ctl.set_param("mc0", "k", 3.0)      # applied before the next batch
        ctl.post_msg("fwd0", "in", {"cmd": "retune"})
        ctl.stop()

Every request is answered; set_param and post_msg find the block BY NAME
in the partition and go through the ordinary control plane
(``Block.set_param``, which the runner applies between batches, and the
runner's message queue, drained between batches), so remote and local
control land at the same batch boundaries.

**SECURITY — read before binding anything but loopback.** Values ride as
pickle, and unpickling attacker-controlled bytes is REMOTE CODE
EXECUTION: anyone who can reach the port owns the process. This is the
reference's trust model (its runtime_proxy executes whatever its peer
runtimes send), so deploy accordingly: bind loopback
(``tcp://127.0.0.1:...``) or ``ipc://`` endpoints, or a private cluster
interface, never ``tcp://*``. For links that cross a machine boundary,
pass a shared ``auth_key`` to BOTH ends. Each frame then carries an
HMAC-SHA256 tag that the server checks BEFORE any ``pickle.loads``, and
replays are refused: every keyed request carries, inside the sealed
payload, the client's session id (16 random bytes) and a counter; the
server refuses a counter that is not above the last one it saw for that
session before it unpickles or acts on anything, and each keyed reply
names the session and counter of the request it answers, which the
client checks. Refusals go back unsealed, for a client without the key to
read. The HMAC authenticates but does not encrypt: use a private network
or a tunnel for confidentiality. Binding a tcp address whose host is not
loopback (parsed exactly: 127.0.0.0/8, ::1, ``localhost``) without an
auth_key logs a warning; ``ipc://`` never does.

**The wire.** Unkeyed, it is the reference's: one pickled dict each way,
so a JAX ``RuntimeClient`` drives a port ``ControlServer`` and the other
way round. Keyed, a sealed payload is ``_GUARD`` + session + counter +
pickle, which the reference's keyed frames (tag + pickle) lack: a keyed
port server therefore refuses a keyed JAX client, and a keyed JAX server
a keyed port client.

**get_param reads the pending value:** the host-side value, which the
device step picks up at the next batch (graph mode: the next chunk), so a
get_param right after a set_param reports the new value, maybe one batch
before the device computes with it.
"""

from __future__ import annotations

import hashlib
import hmac as hmac_mod
import ipaddress
import pickle
import secrets
import struct
import threading
import time
from typing import Any

from newsched_tpu_torch.io import zmtp
from newsched_tpu_torch.utils.logger import get_logger

log = get_logger("control")

_TAG_LEN = 32                 # HMAC-SHA256
_GUARD = b"NSTC1"             # a keyed payload with the replay guard
_SESSION_LEN = 16
_HEAD_LEN = len(_GUARD) + _SESSION_LEN + 8


def _seal(payload: bytes, key: bytes | None) -> bytes:
    if key is None:
        return payload
    return hmac_mod.new(key, payload, hashlib.sha256).digest() + payload


def _unseal(frame: bytes, key: bytes | None) -> bytes | None:
    """Payload if authentic, None otherwise. MUST run before any
    deserialization: pickle.loads on an unauthenticated frame is RCE."""
    if key is None:
        return frame
    if len(frame) < _TAG_LEN:
        return None
    tag, payload = frame[:_TAG_LEN], frame[_TAG_LEN:]
    good = hmac_mod.new(key, payload, hashlib.sha256).digest()
    return payload if hmac_mod.compare_digest(tag, good) else None


def _guarded(session: bytes, counter: int, body: bytes) -> bytes:
    return _GUARD + session + struct.pack(">Q", counter) + body


def _split_guard(payload: bytes) -> tuple[bytes, int, bytes] | None:
    """(session, counter, pickle) of a keyed payload, None without the
    guard (a reference client's keyed frame)."""
    if len(payload) < _HEAD_LEN or not payload.startswith(_GUARD):
        return None
    i = len(_GUARD)
    session = payload[i:i + _SESSION_LEN]
    (counter,) = struct.unpack(">Q", payload[i + _SESSION_LEN:_HEAD_LEN])
    return session, counter, payload[_HEAD_LEN:]


def request_frame(req: dict, key: bytes | None, session: bytes,
                  counter: int) -> bytes:
    """The bytes a RuntimeClient sends for ``req``: the reference's pickle
    unkeyed; keyed, sealed with the session and counter inside."""
    body = pickle.dumps(req)
    if key is None:
        return body
    return _seal(_guarded(session, counter, body), key)


def is_loopback(address: str) -> bool:
    """Whether ``address`` is reachable only from this host: any
    ``ipc://`` path, or a ``tcp://`` one whose host, parsed exactly, is
    ``localhost`` or a loopback IP (127.0.0.0/8, ::1)."""
    scheme, _, rest = address.partition("://")
    if scheme == "ipc":
        return True
    if scheme != "tcp":
        return False
    host = rest.rpartition(":")[0]
    if host.startswith("[") and host.endswith("]"):
        host = host[1:-1]
    if host.lower() == "localhost":
        return True
    try:
        return ipaddress.ip_address(host).is_loopback
    except ValueError:  # a name, an interface or "*"
        return False


def _warn_if_exposed(address: str, key: bytes | None) -> None:
    if key is None and not is_loopback(address):
        log.warning(
            "control plane bound to %s WITHOUT auth_key: the wire format "
            "is pickle (= remote code execution for any peer that can "
            "connect). Bind loopback/ipc, or pass a shared auth_key.",
            address)


class ControlServer:
    """REP socket serving ping, stop, set_param, get_param and post_msg
    for one partition, on a thread of its own; requests change host-side
    block and runner state, which the runner takes up at its batch
    boundaries."""

    def __init__(self, address: str, resolve_runner, resolve_block,
                 auth_key: bytes | None = None):
        """resolve_runner() -> Runner | None (None while starting up);
        resolve_block(name) -> Block | None. auth_key: the shared HMAC key
        (the module docstring's security note)."""
        self.address = address
        self._resolve_runner = resolve_runner
        self._resolve_block = resolve_block
        self._key = auth_key
        self._last: dict[bytes, int] = {}  # session -> its highest counter
        _warn_if_exposed(address, auth_key)
        self._sock = zmtp.Socket(zmtp.REP)
        self._sock.bind(address)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name=f"control-{address}")
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)
        self._sock.close(0)

    def _serve(self) -> None:
        while not self._stop.is_set():
            if not self._sock.poll(100):
                continue
            frame = self._sock.recv()
            try:
                reply = self._answer(frame)
            except Exception as e:  # malformed frame or handler error
                reply = pickle.dumps({"ok": False, "error": repr(e)})
            try:
                self._sock.send(reply)
            except zmtp.ZMTPError:
                log.exception("control reply failed")

    def _answer(self, frame: bytes) -> bytes:
        """The reply frame to one request frame. Keyed: checked, then its
        counter checked against its session, before anything is
        unpickled; the reply sealed and naming the request."""
        if self._key is None:
            return pickle.dumps(self._handle(pickle.loads(frame)))
        payload = _unseal(frame, self._key)
        if payload is None:
            log.warning("control frame failed HMAC auth: dropped without "
                        "deserializing")
            return pickle.dumps({"ok": False, "error": "auth failed"})
        parts = _split_guard(payload)
        if parts is None:
            return pickle.dumps({"ok": False, "error": (
                "keyed request without the replay guard (a reference "
                "client?): refused")})
        session, counter, body = parts
        if counter <= self._last.get(session, 0):
            log.warning("replayed control frame (counter %d) refused", counter)
            return pickle.dumps({"ok": False, "error": (
                f"replayed request refused: counter {counter} is not above "
                f"{self._last[session]}")})
        self._last[session] = counter
        rep = self._handle(pickle.loads(body))
        return _seal(_guarded(session, counter, pickle.dumps(rep)), self._key)

    def _wait_runner(self, timeout: float = 10.0):
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout:
            r = self._resolve_runner()
            if r is not None:
                return r
            time.sleep(0.01)
        return None

    def _handle(self, req: dict) -> dict:
        op = req.get("op")
        if op == "ping":
            return {"ok": True}
        if op == "stop":
            r = self._wait_runner()
            if r is None:
                return {"ok": False, "error": "no runner"}
            r.request_stop()
            return {"ok": True}
        blk = self._resolve_block(req.get("block", ""))
        if blk is None:
            return {"ok": False,
                    "error": f"no block named {req.get('block')!r} here"}
        if op == "set_param":
            blk.set_param(req["param"], req["value"])
            return {"ok": True}
        if op == "get_param":
            return {"ok": True, "value": blk.get_param(req["param"])}
        if op == "post_msg":
            r = self._wait_runner()
            if r is None:
                return {"ok": False, "error": "no runner"}
            r.enqueue_msg(blk, req["port"], req["msg"])
            return {"ok": True}
        return {"ok": False, "error": f"unknown op {op!r}"}


class RuntimeClient:
    """REQ-side handle to a remote partition's ControlServer. Each call
    waits up to ``timeout_ms`` to send and as long for the reply
    (``zmtp.Again`` past it)."""

    def __init__(self, address: str, timeout_ms: int = 5000,
                 auth_key: bytes | None = None):
        self._key = auth_key
        self._session = secrets.token_bytes(_SESSION_LEN)
        self._counter = 0
        self._sock = zmtp.Socket(zmtp.REQ)
        self._sock.setsockopt(zmtp.RCVTIMEO, timeout_ms)
        self._sock.setsockopt(zmtp.SNDTIMEO, timeout_ms)
        self._sock.setsockopt(zmtp.LINGER, 0)
        self._sock.connect(address)

    def _call(self, **req) -> Any:
        self._counter += 1
        self._sock.send(request_frame(req, self._key, self._session,
                                      self._counter))
        frame = self._sock.recv()
        if self._key is None:
            rep = pickle.loads(frame)
        else:
            payload = _unseal(frame, self._key)
            parts = None if payload is None else _split_guard(payload)
            if parts is None:
                raise RuntimeError("remote control reply failed HMAC auth "
                                   "(a refusal comes back unsealed)")
            if parts[:2] != (self._session, self._counter):
                raise RuntimeError("remote control reply answers another "
                                   "request")
            rep = pickle.loads(parts[2])
        if not rep.get("ok"):
            raise RuntimeError(f"remote control failed: {rep.get('error')}")
        return rep.get("value")

    def ping(self) -> None:
        self._call(op="ping")

    def set_param(self, block: str, param: str, value) -> None:
        """Set a parameter of a block in the remote partition; its runner
        applies it before the next batch (as a local Block.set_param mid-run)."""
        self._call(op="set_param", block=block, param=param, value=value)

    def get_param(self, block: str, param: str):
        return self._call(op="get_param", block=block, param=param)

    def post_msg(self, block: str, port: str, msg) -> None:
        """Deliver a message to a remote block's input message port (its
        runner drains it between batches, as a local enqueue_msg)."""
        self._call(op="post_msg", block=block, port=port, msg=msg)

    def stop(self) -> None:
        self._call(op="stop")

    def close(self) -> None:
        self._sock.close(0)
