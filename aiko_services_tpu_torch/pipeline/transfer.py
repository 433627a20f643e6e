# Binary tensor transfer plane for CROSS-PROCESS pipeline hops.
#
# The reference moves tensors between processes as base64/zlib text through
# the MQTT broker (reference: src/aiko_services/examples/pipeline/
# elements.py:298-324 PE_DataEncode/Decode; elements/media/audio_io.py:
# 520-560 PE_RemoteSend binary topics, enabled by process.py:180-189).
# Routing bulk data through a broker caps throughput at the broker.
#
# Here the data plane is split from the control plane (SURVEY.md 5,
# "Distributed communication backend"): the broker carries only a small
# JSON DESCRIPTOR {host, port, key, dtype, shape}; the bytes ride a direct
# TCP connection between the producing and consuming processes.  Within a
# mesh, sharded compute never touches this path (XLA collectives over
# ICI/DCN); the transfer plane covers pipeline-stage hand-off between
# framework Processes on one or many hosts.
#
# Protocol (request/response, PIPELINED on one connection):
#   client -> server: 32-byte hex key + "\n"
#   server -> client: 8-byte big-endian length + raw array bytes
#                     (length 0 = unknown/expired key)
# dtype/shape travel in the descriptor, so the wire carries nothing but
# the buffer.  A client may send further keys on the same connection
# after reading each response (fetch_many batches a whole descriptor
# tree -- a warm-start weight hand-off, a KV-block migration -- into
# ONE connection per peer instead of one TCP handshake per leaf); a
# client that closes after one response gets the historical
# one-request-per-connection behavior.
#
# Failure contract: fetch() raises TransferError (a ValueError) on any
# network fault and KeyError on expired/consumed keys -- both inside the
# pipeline engine's undecodable-frame handling, so a dead producer drops
# the frame instead of killing the consumer's event loop.
#
# Counterpart of aiko_services_tpu/pipeline/transfer.py.  torch.Tensor
# leaves are offered from host copies; numpy has no bfloat16, so a bf16
# tensor travels as its raw uint16 bits under dtype "bfloat16" and is
# fetched back as a torch.bfloat16 tensor (the JAX package used ml_dtypes).

from __future__ import annotations

import os
import socket
import struct
import threading
import time

import numpy as np
import torch

from ..faults import get_injector
from ..observe.metrics import get_registry

__all__ = [
    "TensorTransferServer", "TransferError", "fetch", "fetch_many",
    "get_transfer_server", "transfer_enabled", "transfer_threshold",
    "reset_transfer_server", "reset_circuits", "transfer_circuit_ms",
]

_HEADER = struct.Struct("!Q")
_KEY_BYTES = 32  # 16 random bytes in hex
_PURGE_INTERVAL = 5.0
# offer() sweeps the store for expired keys at most this often: a sweep
# scans every entry, and a producer offering per block (the decode
# checkpointer, the prefill handoff) would otherwise pay O(store) per
# offer; an expired key lives at most this much longer
_OFFER_PURGE_INTERVAL = 0.1

TENSOR_REF_KEY = "__tensorref__"


class TransferError(ValueError):
    """A transfer-plane fetch failed (producer unreachable, stream cut).
    Subclasses ValueError so pipeline frame decoding treats it as an
    undecodable frame (dropped + logged), never a crashed handler."""


def transfer_enabled() -> bool:
    """Kill switch: AIKO_TRANSFER=0 forces every cross-process tensor
    back onto the inline base64 codec path."""
    return os.environ.get("AIKO_TRANSFER", "1") not in ("0", "false")


def transfer_threshold() -> int:
    """Arrays at or above this many bytes ride the transfer plane;
    smaller values stay inline in the control message (a descriptor +
    round-trip costs more than a small payload)."""
    return int(os.environ.get("AIKO_TRANSFER_THRESHOLD", str(1 << 16)))


def transfer_timeout() -> float:
    """Socket timeout for fetches.  Fetches run on the consumer's event
    loop, so this bounds how long one lost producer can stall the
    process; keep it well under stream grace leases."""
    return float(os.environ.get("AIKO_TRANSFER_TIMEOUT", "10"))


def transfer_retries() -> int:
    """Network-fault fetch attempts beyond the first.  A producer
    restart, a dropped TCP handshake, or a transient route flap is the
    steady state at fleet scale; one or two quick retries recover the
    frame where the old fail-fast contract dropped it.  Expired keys
    (KeyError) are never retried -- a consumed key will not come back."""
    return int(os.environ.get("AIKO_TRANSFER_RETRIES", "2"))


def transfer_retry_backoff() -> float:
    """Base retry backoff seconds (doubles per attempt)."""
    return float(os.environ.get("AIKO_TRANSFER_RETRY_MS", "50")) / 1000.0


def transfer_linger() -> float:
    """How long a key stays fetchable AFTER its first fetch.  Broker
    redelivery or a second subscriber on the hop topic (monitoring,
    debug taps) may fetch the same descriptor; dropping the key on first
    read would turn those into lost frames.  Kept SHORT: every delivered
    tensor stays resident on the producer for the linger window, so at
    steady-state streaming (frames/s x bytes/frame) the default bounds
    extra memory to a few seconds' worth of traffic; redelivery resolves
    well inside that."""
    return float(os.environ.get("AIKO_TRANSFER_LINGER", "5"))


def transfer_circuit_ms() -> float:
    """Per-peer circuit-breaker window in milliseconds (0 disables).
    A peer that exhausts a fetch's whole retry budget is marked dead
    for this window; until it heals, every fetch/fetch_many against it
    FAILS FAST with TransferError instead of burning the full
    AIKO_TRANSFER_RETRIES x AIKO_TRANSFER_RETRY_MS budget on the
    caller's event loop -- adoption and checkpoint-restore failures
    drop straight to their local-re-prefill fallback."""
    return float(os.environ.get("AIKO_TRANSFER_CIRCUIT_MS", "2000"))


# (host, port) -> monotonic deadline until which the peer is presumed
# dead.  Any SUCCESSFUL connection (including an expired-key reply:
# the peer answered) closes the circuit early.
_CIRCUITS: dict[tuple, float] = {}
_CIRCUIT_LOCK = threading.Lock()


def _circuit_open(address: tuple) -> bool:
    if not _CIRCUITS:
        return False  # lock-free fast path for the healthy fleet
    with _CIRCUIT_LOCK:
        deadline = _CIRCUITS.get(address)
        if deadline is None:
            return False
        if time.monotonic() >= deadline:
            del _CIRCUITS[address]
            return False
        return True


def _trip_circuit(address: tuple) -> None:
    window = transfer_circuit_ms()
    if window <= 0:
        return
    with _CIRCUIT_LOCK:
        _CIRCUITS[address] = time.monotonic() + window / 1000.0
    get_registry().counter("transfer.peer_open_circuits").inc()


def _close_circuit(address: tuple) -> None:
    if not _CIRCUITS:
        return
    with _CIRCUIT_LOCK:
        _CIRCUITS.pop(address, None)


def _circuit_fast_fail(address: tuple) -> None:
    get_registry().counter("transfer.circuit_fast_fails").inc()
    raise TransferError(
        f"transfer circuit open to {address[0]}:{address[1]} (peer "
        f"marked dead for {transfer_circuit_ms():g} ms after "
        f"exhausting its retry budget)")


def reset_circuits() -> None:
    with _CIRCUIT_LOCK:
        _CIRCUITS.clear()


def _advertised_host() -> str:
    """The address peers should dial: env override, else this host's
    outbound interface (UDP connect trick -- no packets sent), else the
    resolved hostname, else loopback (single-host deployments)."""
    override = os.environ.get("AIKO_TRANSFER_HOST")
    if override:
        return override
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as probe:
            probe.connect(("10.255.255.255", 1))
            address = probe.getsockname()[0]
        if address and not address.startswith("127."):
            return address
    except OSError:
        pass
    try:
        address = socket.gethostbyname(socket.gethostname())
        if address and not address.startswith("127."):
            return address
    except OSError:
        pass
    return "127.0.0.1"


def host_bits(value) -> tuple:
    """(contiguous host numpy array of value's bits, dtype name): a
    tensor is copied to the host; bfloat16, which numpy lacks, is viewed
    as its uint16 bits under the name "bfloat16"."""
    if isinstance(value, torch.Tensor):
        tensor = value.detach().cpu().contiguous()
        if tensor.dtype == torch.bfloat16:
            bits = tensor.view(torch.int16).numpy().view(np.uint16)
            return bits, "bfloat16"
        array = tensor.numpy()
        return array, str(array.dtype)
    array = np.ascontiguousarray(np.asarray(value))
    return array, str(array.dtype)


def from_bits(raw, dtype_name: str, shape):
    """Inverse of host_bits: a numpy array, or a torch.bfloat16 tensor
    for dtype "bfloat16"."""
    if dtype_name == "bfloat16":
        bits = np.frombuffer(raw, dtype=np.int16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(raw, dtype=np.dtype(dtype_name)).reshape(shape)


class TensorTransferServer:
    """Per-process tensor side-channel: offered arrays are served by key
    until ttl expires.  A key stays valid for transfer_linger() seconds
    after its first fetch (re-fetchable across broker redelivery or a
    second hop-topic subscriber), then expires; expired keys are swept
    by offer() (at most every _OFFER_PURGE_INTERVAL seconds) and
    periodically by the accept loop, and a fetch never serves one.  The listen interface
    defaults to all interfaces; set AIKO_TRANSFER_BIND to restrict (the
    key is otherwise the only access control)."""

    def __init__(self, host: str | None = None, port: int = 0,
                 ttl: float = 300.0):
        self.ttl = float(ttl)
        self._store: dict[str, tuple[float, np.ndarray]] = {}
        self._lock = threading.Lock()
        self._purged_at = time.monotonic()
        self._listener = self._make_listener(int(port))
        self.port = self._listener.getsockname()[1]
        self.host = host or _advertised_host()
        self._closed = False
        self._thread = threading.Thread(
            target=self._accept_loop, name="tensor_transfer", daemon=True)
        self._thread.start()

    @staticmethod
    def _make_listener(port: int) -> socket.socket:
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        bind_host = os.environ.get("AIKO_TRANSFER_BIND", "0.0.0.0")
        listener.bind((bind_host, port))
        listener.listen(16)
        listener.settimeout(_PURGE_INTERVAL)
        return listener

    # -- producer side -------------------------------------------------

    def offer(self, array) -> dict:
        """Stage an array or tensor for remote fetch; returns its
        descriptor."""
        return self.offer_many([array])[0]

    def offer_many(self, arrays, dtype_name: str | None = None) -> list:
        """offer() for several arrays or tensors at once: one draw of
        random keys, one lock, one metrics update and at most one sweep
        for all of them; returns their descriptors in order.  With
        `dtype_name`, every entry is already a contiguous host numpy
        array of that dtype's bits (a slice of what host_bits returned),
        served as is."""
        if dtype_name is None:
            staged = [host_bits(array) for array in arrays]
        else:
            staged = [(array, dtype_name) for array in arrays]
        keys = os.urandom(_KEY_BYTES // 2 * len(staged)).hex()
        deadline = time.monotonic() + self.ttl
        descriptors = []
        with self._lock:
            for index, (array, name) in enumerate(staged):
                key = keys[index * _KEY_BYTES:(index + 1) * _KEY_BYTES]
                self._store[key] = (deadline, array)
                descriptors.append(
                    {"host": self.host, "port": self.port, "key": key,
                     "dtype": name, "shape": list(array.shape)})
        metrics = get_registry()
        metrics.counter("transfer.offers").inc(len(staged))
        metrics.counter("transfer.offered_bytes").inc(
            sum(array.nbytes for array, _ in staged))
        if time.monotonic() - self._purged_at >= _OFFER_PURGE_INTERVAL:
            self._purge()
        return descriptors

    def _purge(self):
        now = time.monotonic()
        self._purged_at = now
        with self._lock:
            expired = [key for key, (deadline, _) in self._store.items()
                       if deadline < now]
            for stale in expired:
                del self._store[stale]

    # -- server side ---------------------------------------------------

    def _accept_loop(self):
        while not self._closed:
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                self._purge()  # unfetched arrays die on schedule
                continue
            except OSError:
                if self._closed:
                    return  # deliberate close()
                # UNEXPECTED listener death (fd exhaustion, an injected
                # kill, a stack reset): the advertised (host, port) is
                # baked into every outstanding descriptor, so restart
                # the accept loop on the SAME port instead of silently
                # turning every future fetch into a dropped frame
                if not self._restart_listener():
                    return
                continue
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def _restart_listener(self) -> bool:
        get_registry().counter("transfer.listener_restarts").inc()
        try:
            self._listener.close()
        except OSError:
            pass
        for attempt in range(5):
            if self._closed:
                return False
            try:
                listener = self._make_listener(self.port)
            except OSError:
                time.sleep(0.1 * (2.0 ** attempt))  # port still in TIME_WAIT
                continue
            with self._lock:
                if self._closed:
                    # close() raced the rebind: a fresh listener behind
                    # a closed server would leak the socket (and hold a
                    # pinned port against the replacement singleton)
                    listener.close()
                    return False
                self._listener = listener
            return True
        # give up with REAL close() semantics: _closed must flip so
        # get_transfer_server() replaces this instance instead of
        # handing out descriptors nobody will ever serve
        self.close()
        return False

    def _handle(self, conn: socket.socket):
        try:
            conn.settimeout(transfer_timeout())
            injector = get_injector()
            if injector is not None:
                # seeded per-connection stall (faults.py transfer_stall):
                # a wedged keeper/producer that accepts but never
                # answers -- the client's socket timeout, not this
                # sleep, bounds the caller
                stall = injector.transfer_stall()
                if stall > 0:
                    time.sleep(stall)
            # the pipelined protocol writes a small header before each
            # buffer; Nagle + delayed ACK would turn every round trip
            # into a ~40 ms stall
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            get_registry().counter("transfer.connections").inc()
            # pipelined request loop: serve keys until the client closes
            # (a single-fetch client closes after one response, which is
            # the historical contract; fetch_many keeps the connection
            # open across a whole descriptor tree)
            while True:
                request = b""
                while not request.endswith(b"\n"):
                    chunk = conn.recv(_KEY_BYTES + 1 - len(request))
                    if not chunk:
                        return
                    request += chunk
                key = request.strip().decode("ascii", "replace")
                now = time.monotonic()
                with self._lock:
                    entry = self._store.get(key)
                    if entry is not None and entry[0] < now:
                        del self._store[key]
                        entry = None
                    elif entry is not None:
                        # first fetch starts the linger clock; later
                        # fetches within the window reuse the same
                        # (shortened) deadline
                        deadline = min(entry[0], now + transfer_linger())
                        self._store[key] = (deadline, entry[1])
                if entry is None:
                    conn.sendall(_HEADER.pack(0))
                    continue
                _, array = entry
                try:  # zero-copy stream of the contiguous buffer
                    view = memoryview(array).cast("B")
                except (TypeError, ValueError, BufferError):
                    view = array.tobytes()  # exotic dtypes w/o buffers
                conn.sendall(_HEADER.pack(array.nbytes))
                conn.sendall(view)
                get_registry().counter(
                    "transfer.served_bytes").inc(array.nbytes)
        except OSError:
            pass
        finally:
            conn.close()

    def close(self):
        self._closed = True
        with self._lock:
            # under the lock: _restart_listener swaps self._listener
            # under the same lock, so the close always hits the LIVE
            # listener, never a just-replaced stale reference
            try:
                self._listener.close()
            except OSError:
                pass
            self._store.clear()


def fetch(descriptor: dict, timeout: float | None = None,
          retries: int | None = None) -> np.ndarray:
    """Dial the descriptor's producer and pull the raw buffer,
    retrying network faults with exponential backoff (the linger window
    keeps the key fetchable across the retry span).

    Returns a WRITABLE array (received into a fresh bytearray).  Raises
    KeyError for consumed/expired keys (never retried), TransferError
    after `retries` + 1 failed network attempts.  Counters:
    `transfer.fetch_errors` counts every FAILED ATTEMPT,
    `transfer.fetch_retries` every retry taken -- on a run where every
    retry recovered, the two reconcile (errors == retries)."""
    if timeout is None:
        timeout = transfer_timeout()
    if retries is None:
        retries = transfer_retries()
    address = (descriptor["host"], int(descriptor["port"]))
    if _circuit_open(address):
        _circuit_fast_fail(address)
    metrics = get_registry()
    fetch_start = time.perf_counter()
    backoff = transfer_retry_backoff()
    injector = get_injector()
    attempt = 0
    while True:
        try:
            if injector is not None and injector.fetch_drop():
                raise OSError("injected socket drop (fetch_drop)")
            with socket.create_connection(address,
                                          timeout=timeout) as conn:
                conn.settimeout(timeout)
                conn.setsockopt(socket.IPPROTO_TCP,
                                socket.TCP_NODELAY, 1)
                conn.sendall(descriptor["key"].encode("ascii") + b"\n")
                header = _recv_exact(conn, _HEADER.size)
                (length,) = _HEADER.unpack(header)
                if length == 0:
                    metrics.counter("transfer.fetch_expired").inc()
                    # the peer ANSWERED: it is alive, the key is gone
                    _close_circuit(address)
                    raise KeyError(
                        f"tensor {descriptor['key']} expired at "
                        f"{address[0]}:{address[1]}")
                raw = _recv_exact(conn, length)
            break
        except OSError as error:
            metrics.counter("transfer.fetch_errors").inc()
            if attempt >= retries:
                _trip_circuit(address)
                raise TransferError(
                    f"tensor fetch from {address[0]}:{address[1]} "
                    f"failed after {attempt + 1} attempts: "
                    f"{error}") from error
            metrics.counter("transfer.fetch_retries").inc()
            time.sleep(backoff * (2.0 ** attempt))
            attempt += 1
    _close_circuit(address)
    metrics.counter("transfer.fetches").inc()
    metrics.counter("transfer.fetched_bytes").inc(length)
    metrics.histogram("transfer.fetch_s").record(
        time.perf_counter() - fetch_start)
    return from_bits(raw, descriptor["dtype"], descriptor["shape"])


def fetch_many(descriptors, timeout: float | None = None,
               retries: int | None = None) -> list:
    """Fetch a whole batch of descriptors with ONE connection per peer,
    pipelining key requests over it -- the descriptor-tree fast path
    (warm-start weight hand-off, prefill->decode KV migration).  A
    per-leaf fetch() pays a TCP handshake per tensor; at KV-block
    granularity that is dozens of round trips per prompt, and the
    handshake -- not the bytes -- dominates.  Here a prompt's KV
    migrates in one connection per producing peer.

    Returns arrays in input order.  Raises KeyError on the first
    consumed/expired key (never retried) and TransferError after the
    retry budget; a connection cut mid-batch retries only the keys not
    yet received.  `transfer.batched_fetches` counts connections this
    path opened; `transfer.fetches`/`fetched_bytes` count per-leaf as
    on the single-fetch path, so the two reconcile."""
    if timeout is None:
        timeout = transfer_timeout()
    if retries is None:
        retries = transfer_retries()
    metrics = get_registry()
    injector = get_injector()
    results: list = [None] * len(descriptors)
    by_peer: dict[tuple, list] = {}
    for index, descriptor in enumerate(descriptors):
        address = (descriptor["host"], int(descriptor["port"]))
        by_peer.setdefault(address, []).append(index)
    fetch_start = time.perf_counter()
    for address, indices in by_peer.items():
        if _circuit_open(address):
            _circuit_fast_fail(address)
        backoff = transfer_retry_backoff()
        attempt = 0
        remaining = list(indices)
        while remaining:
            try:
                if injector is not None and injector.fetch_drop():
                    raise OSError("injected socket drop (fetch_drop)")
                with socket.create_connection(
                        address, timeout=timeout) as conn:
                    conn.settimeout(timeout)
                    # a batch alternates small key writes with reads:
                    # Nagle + delayed ACK would cost ~40 ms per leaf
                    conn.setsockopt(socket.IPPROTO_TCP,
                                    socket.TCP_NODELAY, 1)
                    metrics.counter("transfer.batched_fetches").inc()
                    while remaining:
                        index = remaining[0]
                        descriptor = descriptors[index]
                        conn.sendall(
                            descriptor["key"].encode("ascii") + b"\n")
                        header = _recv_exact(conn, _HEADER.size)
                        (length,) = _HEADER.unpack(header)
                        if length == 0:
                            metrics.counter(
                                "transfer.fetch_expired").inc()
                            _close_circuit(address)
                            raise KeyError(
                                f"tensor {descriptor['key']} expired "
                                f"at {address[0]}:{address[1]}")
                        raw = _recv_exact(conn, length)
                        results[index] = from_bits(
                            raw, descriptor["dtype"],
                            descriptor["shape"])
                        metrics.counter("transfer.fetches").inc()
                        metrics.counter(
                            "transfer.fetched_bytes").inc(length)
                        remaining.pop(0)
            except OSError as error:
                metrics.counter("transfer.fetch_errors").inc()
                if attempt >= retries:
                    _trip_circuit(address)
                    raise TransferError(
                        f"batched tensor fetch from "
                        f"{address[0]}:{address[1]} failed after "
                        f"{attempt + 1} attempts with "
                        f"{len(remaining)} leaves left: "
                        f"{error}") from error
                metrics.counter("transfer.fetch_retries").inc()
                time.sleep(backoff * (2.0 ** attempt))
                attempt += 1
        _close_circuit(address)
    metrics.histogram("transfer.fetch_s").record(
        time.perf_counter() - fetch_start)
    return results


def _recv_exact(conn: socket.socket, count: int) -> bytearray:
    buffer = bytearray(count)
    view = memoryview(buffer)
    received = 0
    while received < count:
        chunk = conn.recv_into(view[received:], count - received)
        if not chunk:
            raise ConnectionError(
                "tensor transfer connection closed mid-stream")
        received += chunk
    return buffer


_SERVER: TensorTransferServer | None = None
_SERVER_LOCK = threading.Lock()


def get_transfer_server() -> TensorTransferServer:
    """Lazily started per-process singleton (first large tensor to cross
    a process boundary brings the listener up)."""
    global _SERVER
    with _SERVER_LOCK:
        if _SERVER is None or _SERVER._closed:
            _SERVER = TensorTransferServer()
        return _SERVER


def reset_transfer_server():
    global _SERVER
    with _SERVER_LOCK:
        if _SERVER is not None:
            _SERVER.close()
            _SERVER = None
