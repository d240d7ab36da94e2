"""Worker transports: the router's frame protocol over pipes or TCP — the
port's copy of ``nonlocalheatequation_torch/serve/transport.py``.

The replica router (serve/router.py) talks to its workers in
length-prefixed frames — a little-endian u64 payload length followed by
the payload (the same length-field convention as the checkpoint and
program-store on-disk formats).  This module holds the protocol so one
replica can be a child process over pipes or a worker dialing in over a
socket — the reference's many-locality tier (``srun -n N`` re-running the
same binary, README.md:64-72) mapped onto sockets:

* :class:`PipeTransport` — the default: the worker is a child process
  (``python -m nonlocalheatequation_torch.serve.router``, started by exec,
  never forked from a process that may hold a CUDA context), frames ride
  its stdin/stdout pipes, and the worker takes fd 1 before it imports
  torch so stray prints cannot tear the framing.
* :class:`SocketTransport` — the router binds a listener and each
  worker is started with ``--worker-connect host:port``: it dials in,
  sends a HELLO frame, and from then on speaks the identical frames
  over the socket.  Reader-EOF death detection, the delivery ledger,
  ``die@`` chaos, and the trace/clock_sync exchange all work unchanged
  because the router only ever sees a framed byte stream.

Frames carry NumPy arrays and plain values only: a worker fetches its
states to host memory before it writes a result frame, so unpickling a
frame never touches the card in the router's process.

**Trust boundary** (the program store's, now on the wire): post-hello
frames deserialize through :mod:`pickle`, which executes arbitrary
code on load — exactly like the program store's on-disk entries
(serve/program_store.py docstring).  The rules that make that safe:

* the listener binds **127.0.0.1 by default**, where the router and
  its workers are one principal on one host (the pipe trust model);
* a **non-loopback bind refuses to construct without a shared-secret
  token** (``--worker-token`` / ``NLHEAT_WORKER_TOKEN``), checked on
  the hello frame before anything else is read from the connection;
* the hello frame itself is **JSON, never pickle** — no bytes from a
  connection are unpickled until its token has been verified, so an
  unauthenticated peer can probe the port but never reach the
  deserializer;
* frame lengths are bounded (:data:`MAX_FRAME_BYTES`) and a
  malformed / oversized / truncated prefix or a mid-frame disconnect
  reads as ``None`` — the caller classifies that as replica DEATH
  (orphan re-route, respawn floor), never as a crash or a reader
  thread parked on a half-frame forever.

A token authenticates, it does not encrypt: on an untrusted network
put the wire inside the tunnel/mesh layer you already trust (the same
advice as the program store's "filesystem permissions are the
boundary").
"""

from __future__ import annotations

import hmac
import ipaddress
import json
import pickle
import signal
import socket
import struct
import subprocess
import sys
import threading
import time

#: Frame header: little-endian payload length (matches the checkpoint
#: and program-store on-disk length fields).
LEN = struct.Struct("<Q")

#: Upper bound on one frame's payload.  A 4096^2 f64 state is ~134 MB;
#: 1 GiB leaves headroom for any case this stack serves while making a
#: garbage length prefix (e.g. ASCII read as u64 ~ 10^18) classify as
#: death instead of a memory-exhausting allocation.
MAX_FRAME_BYTES = 1 << 30

#: Hello frames are tiny JSON — anything bigger is not a worker.
MAX_HELLO_BYTES = 1 << 16

#: Environment variable carrying the shared-secret worker token (env,
#: not argv: command lines are world-readable in ``ps``).
WORKER_TOKEN_ENV = "NLHEAT_WORKER_TOKEN"

#: The module whose ``__main__`` is the worker child (serve/router.py).
WORKER_MODULE = "nonlocalheatequation_torch.serve.router"


def write_frame(stream, obj) -> None:
    """One pickle frame onto a writable binary stream (flushes)."""
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    stream.write(LEN.pack(len(payload)))
    stream.write(payload)
    stream.flush()


def read_frame(stream, max_bytes: int = MAX_FRAME_BYTES):
    """One frame off a readable binary stream, or ``None`` for anything
    that means the peer is gone or lying: EOF, a truncated prefix, an
    OVERSIZED length (a garbage prefix must never become a giant
    allocation), or a mid-frame disconnect.  The caller classifies
    ``None`` as worker death.  A payload that unpickles to garbage
    raises — the router's reader thread treats any exception the same
    as EOF (torn frame == dead worker)."""
    head = stream.read(LEN.size)
    if len(head) < LEN.size:
        return None
    n = LEN.unpack(head)[0]
    if n > max_bytes:
        return None
    payload = stream.read(n)
    if len(payload) < n:
        return None
    return pickle.loads(payload)


def write_json_frame(stream, obj: dict) -> None:
    """A length-prefixed JSON frame — the HELLO form: parseable without
    ever handing unauthenticated bytes to pickle."""
    payload = json.dumps(obj).encode()
    stream.write(LEN.pack(len(payload)))
    stream.write(payload)
    stream.flush()


def _recv_exact(conn: socket.socket, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        try:
            chunk = conn.recv(n - len(buf))
        except OSError:
            return None
        if not chunk:
            return None
        buf += chunk
    return buf


def read_hello(conn: socket.socket, timeout_s: float = 5.0) -> dict | None:
    """The hello frame off a fresh connection: length-prefixed JSON,
    bounded, under a read timeout (a dead or malicious connection must
    never park the accept loop).  Returns the hello dict or ``None``
    for anything malformed — the caller drops the connection."""
    try:
        conn.settimeout(timeout_s)
        head = _recv_exact(conn, LEN.size)
        if head is None:
            return None
        n = LEN.unpack(head)[0]
        if n > MAX_HELLO_BYTES:
            return None
        payload = _recv_exact(conn, n)
        if payload is None:
            return None
        hello = json.loads(payload.decode())
        if not isinstance(hello, dict) or hello.get("op") != "hello":
            return None
        return hello
    except (OSError, ValueError, UnicodeDecodeError):
        return None
    finally:
        try:
            conn.settimeout(None)
        except OSError:
            pass


def is_loopback(host: str) -> bool:
    if host in ("localhost", ""):
        return True
    try:
        return ipaddress.ip_address(host).is_loopback
    except ValueError:
        return False


class WorkerHandle:
    """One connected worker, transport-agnostic: framed reader/writer
    plus process control.  The router's writer thread calls
    :meth:`send_frame`, its reader thread :meth:`recv_frame`, the
    ``die`` chaos plan :meth:`kill`, and the death/close paths
    :meth:`reap`."""

    def __init__(self, proc: subprocess.Popen | None, reader, writer,
                 sock: socket.socket | None = None,
                 transport: str = "pipe"):
        self.proc = proc
        self.reader = reader
        self.writer = writer
        self.sock = sock
        self.transport = transport

    def send_frame(self, obj) -> None:
        write_frame(self.writer, obj)

    def recv_frame(self):
        return read_frame(self.reader)

    def kill(self) -> None:
        """SIGKILL the worker process (the deterministic ``die`` chaos;
        the socket/pipe EOF that follows is the death signal the reader
        thread acts on).  A handle without a local process closes the
        socket instead — the remote worker sees EOF and exits."""
        if self.proc is not None:
            try:
                self.proc.send_signal(signal.SIGKILL)
                return
            except OSError:
                pass
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass

    def wait(self, timeout: float | None = None) -> None:
        if self.proc is not None:
            self.proc.wait(timeout=timeout)

    def reap(self, timeout_s: float = 10.0) -> None:
        """Wait for exit (killing on timeout) and close every stream —
        no zombies, no fd leaks, under sustained chaos included."""
        if self.proc is not None:
            try:
                self.proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                try:
                    self.proc.kill()
                except OSError:
                    pass
                try:
                    self.proc.wait(timeout=timeout_s)
                except subprocess.TimeoutExpired:
                    pass
        for stream in (self.writer, self.reader, self.sock):
            if stream is None:
                continue
            try:
                stream.close()
            except OSError:
                pass


class PipeTransport:
    """Today's worker shape: a child process speaking frames over its
    own stdin/stdout pipes (the worker steals fd 1 at startup so stray
    prints go to stderr and can never tear the framing)."""

    name = "pipe"

    def spawn(self, rid: int, env: dict,
              timeout_s: float = 180.0) -> WorkerHandle:
        proc = subprocess.Popen(
            [sys.executable, "-m", WORKER_MODULE],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env)
        return WorkerHandle(proc, proc.stdout, proc.stdin,
                            transport=self.name)

    def close(self) -> None:
        pass


class SocketTransport:
    """TCP workers: the router binds ONE listener; every worker dials
    in (``python -m nonlocalheatequation_torch.serve.router
    --worker-connect host:port``), identifies itself on a JSON hello
    frame (replica id + token), and then speaks the identical pickle
    frames the pipe transport does.

    ``host`` defaults to 127.0.0.1 — binding anything non-loopback
    REFUSES without ``token`` (the module-docstring trust boundary).
    :meth:`spawn` launches a local worker child pointed at the
    listener; a worker started by other means (another host) is
    matched to its replica by the hello's ``replica`` field when its
    connection arrives."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 token: str | None = None):
        if not is_loopback(host) and not token:
            raise ValueError(
                f"SocketTransport bind {host!r} is not loopback: frames "
                "deserialize through pickle (see serve/transport.py "
                "trust boundary) — pass a shared-secret token "
                "(--worker-token) to accept non-local workers")
        self.host = host
        self.token = token
        self._srv = socket.create_server((host, int(port)))
        self.port = self._srv.getsockname()[1]
        #: connections that helloed for a replica nobody asked for YET
        #: (two concurrent spawns can accept each other's workers)
        self._parked: dict[int, socket.socket] = {}  # guarded_by: self._lock
        #: serializes the accept loop: _spawn can run concurrently (a
        #: reader thread's respawn racing an elastic add_replica), and
        #: the listener's settimeout/accept pair is not thread-safe to
        #: interleave — the parked map hands the other spawn's worker
        #: over when the lock holder accepts it first
        self._lock = threading.Lock()
        self._closed = False

    @property
    def name(self) -> str:
        return "tcp"

    def connect_arg(self) -> str:
        host = self.host if self.host not in ("", "0.0.0.0") else "127.0.0.1"
        return f"{host}:{self.port}"

    def spawn(self, rid: int, env: dict,
              timeout_s: float = 180.0) -> WorkerHandle:
        env = dict(env)
        if self.token is not None:
            # env, not argv: command lines are world-readable in ps
            env[WORKER_TOKEN_ENV] = self.token
        proc = subprocess.Popen(
            [sys.executable, "-m", WORKER_MODULE,
             "--worker-connect", self.connect_arg()],
            stdin=subprocess.DEVNULL, env=env)
        try:
            conn = self._accept(rid, timeout_s, proc)
        except BaseException:
            try:
                proc.kill()
            except OSError:
                pass
            raise
        return WorkerHandle(proc, conn.makefile("rb"),
                            conn.makefile("wb"), sock=conn,
                            transport=self.name)

    def _accept(self, rid: int, timeout_s: float,
                proc: subprocess.Popen | None = None) -> socket.socket:
        """Accept until replica ``rid``'s authenticated hello arrives.
        A connection with a wrong/missing token, or any malformed
        hello, is CLOSED and the loop continues — a port scanner or a
        stale worker must never crash the router or occupy the slot.
        Hellos for other replica ids are parked for their own spawn."""
        deadline = time.monotonic() + timeout_s
        while True:
            with self._lock:
                conn = self._parked.pop(rid, None)
            if conn is not None:
                return conn
            if proc is not None and proc.poll() is not None:
                raise RuntimeError(
                    f"worker {rid} exited (rc={proc.returncode}) before "
                    "dialing in")
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"worker {rid} did not dial in within {timeout_s:.0f}s")
            # one accept round per lock hold — but the lock covers ONLY
            # the parked-map check and the accept() call: the hello
            # read (up to 5 s against a slow or malicious peer) happens
            # UNLOCKED, so a trickle of garbage connections can never
            # park a concurrent spawn/respawn past its deadline
            with self._lock:
                if rid in self._parked:
                    continue  # parked for us while we waited on the lock
                self._srv.settimeout(min(remaining, 1.0))
                try:
                    conn, addr = self._srv.accept()
                except socket.timeout:
                    continue
                except OSError as e:
                    raise RuntimeError(
                        f"socket listener closed: {e}") from None
            hello = read_hello(conn)
            if hello is None or not self._token_ok(hello):
                print(f"transport: rejected connection from {addr} "
                      f"({'bad hello' if hello is None else 'bad token'})",
                      file=sys.stderr)
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            try:
                got = int(hello.get("replica"))
            except (TypeError, ValueError):
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            if got == rid:
                return conn
            with self._lock:
                stale = self._parked.pop(got, None)
                self._parked[got] = conn
            if stale is not None:
                # a second dial-in for the same replica id: the older
                # connection is dead weight — close, not leak
                try:
                    stale.close()
                except OSError:
                    pass

    def _token_ok(self, hello: dict) -> bool:
        if self.token is None:
            return True
        offered = hello.get("token")
        return isinstance(offered, str) and hmac.compare_digest(
            offered, self.token)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        with self._lock:
            parked = list(self._parked.values())
            self._parked.clear()
        for conn in parked:
            try:
                conn.close()
            except OSError:
                pass
        try:
            self._srv.close()
        except OSError:
            pass


def make_transport(spec, token: str | None = None):
    """Resolve the router's ``transport=`` argument: ``"pipe"`` (the
    default), ``"tcp"``/``"socket"`` (a fresh loopback
    :class:`SocketTransport`), or an already-constructed transport
    object (``spawn``/``name``/``close``) passed through.  A token with
    the pipe transport refuses loudly: pipes are the same process tree
    and a silently ignored credential would misstate the boundary."""
    if spec is None or spec == "pipe":
        if token is not None:
            raise ValueError(
                "worker_token authenticates SOCKET workers; the pipe "
                "transport is the same process tree (drop the token or "
                "use transport='tcp')")
        return PipeTransport()
    if spec in ("tcp", "socket"):
        return SocketTransport(token=token)
    if hasattr(spec, "spawn") and hasattr(spec, "name"):
        if token is not None and getattr(spec, "token", None) != token:
            raise ValueError(
                "pass the token to the transport you constructed, not "
                "to the router (one credential, one owner)")
        return spec
    raise ValueError(
        f"unknown transport {spec!r}: 'pipe', 'tcp', or a transport "
        "object with spawn()/name/close()")
