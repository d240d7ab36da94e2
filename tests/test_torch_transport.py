"""The port's worker transports (nonlocalheatequation_torch/serve/transport.py)
on the CPU, held against the JAX package's serve/transport.py.

* A frame is the same bytes in both packages (the u64 length prefix and
  the pickle payload), and each package reads the other's frames.
* Truncated, oversized, ASCII-garbage and mid-frame inputs read ``None``
  (a dead or lying peer), as in the JAX module.
* ``read_hello``, ``is_loopback`` and ``make_transport`` answer each input
  as the JAX module does, with its refusal words.
* Over a real loopback socket: a wrong token and a garbage hello are
  dropped before anything is unpickled, the right hello is accepted and
  then speaks pickle frames both ways; a hello for another replica is
  parked for its own spawn.

No worker process is started here (tests/test_torch_router.py does).
"""

import io
import socket
import struct
import threading

import numpy as np
import pytest

from nonlocalheatequation_torch.serve import transport as tt
from nonlocalheatequation_tpu.serve import transport as jt

OBJECTS = [
    {"op": "case", "id": 7},
    {"op": "result", "id": 3, "values": np.arange(12, dtype=np.float64).reshape(3, 4)},
    {"op": "stats", "id": 1, "busy_s": 0.25, "span_s": 1.0, "metrics": {"cases": 2}},
    ("sticky", 5, None, [1.5, "x"]),
]


@pytest.mark.parametrize("obj", OBJECTS, ids=["case", "result", "stats", "tuple"])
def test_frame_bytes_equal_the_jax_module_and_cross_read(obj):
    mine, theirs = io.BytesIO(), io.BytesIO()
    tt.write_frame(mine, obj)
    jt.write_frame(theirs, obj)
    assert mine.getvalue() == theirs.getvalue()
    assert tt.LEN.format == jt.LEN.format and tt.LEN.size == 8
    for reader, buf in ((tt.read_frame, theirs), (jt.read_frame, mine)):
        buf.seek(0)
        got = reader(buf)
        if isinstance(obj, dict) and "values" in obj:
            assert np.array_equal(got["values"], obj["values"])
            assert got["values"].dtype == np.float64
        else:
            assert got == obj
    a, b = io.BytesIO(), io.BytesIO()
    tt.write_json_frame(a, {"op": "hello", "replica": 2, "token": "t"})
    jt.write_json_frame(b, {"op": "hello", "replica": 2, "token": "t"})
    assert a.getvalue() == b.getvalue()


def test_constants_match_the_jax_module():
    assert tt.MAX_FRAME_BYTES == jt.MAX_FRAME_BYTES == 1 << 30
    assert tt.MAX_HELLO_BYTES == jt.MAX_HELLO_BYTES
    assert tt.WORKER_TOKEN_ENV == jt.WORKER_TOKEN_ENV == "NLHEAT_WORKER_TOKEN"
    assert tt.WORKER_MODULE == "nonlocalheatequation_torch.serve.router"


BAD_STREAMS = {
    "truncated-prefix": b"\x01\x02\x03",
    "oversized": struct.pack("<Q", (1 << 30) + 1) + b"x",
    "ascii-garbage": b"GET / HTTP/1.1\r\n\r\n",
    "mid-frame": struct.pack("<Q", 100) + b"only-ten-b",
    "empty": b"",
}


@pytest.mark.parametrize("name", sorted(BAD_STREAMS))
def test_torn_and_lying_frames_read_none(name):
    raw = BAD_STREAMS[name]
    assert tt.read_frame(io.BytesIO(raw)) is None
    assert jt.read_frame(io.BytesIO(raw)) is None
    # a tighter bound refuses what the default admits, in both
    buf = io.BytesIO()
    tt.write_frame(buf, {"op": "case", "id": 1, "pad": "x" * 64})
    raw = buf.getvalue()
    assert tt.read_frame(io.BytesIO(raw), max_bytes=16) is None
    assert jt.read_frame(io.BytesIO(raw), max_bytes=16) is None


@pytest.mark.parametrize("host", ["localhost", "", "127.0.0.1", "127.8.9.1", "::1",
                                  "0.0.0.0", "10.0.0.1", "example.org", "::"])
def test_is_loopback_matches_the_jax_module(host):
    assert tt.is_loopback(host) == jt.is_loopback(host)


def _hello_pair(payload: bytes):
    """(port read_hello, JAX read_hello) of the same raw bytes over two
    socket pairs."""
    out = []
    for mod in (tt, jt):
        a, b = socket.socketpair()
        try:
            a.sendall(payload)
            a.shutdown(socket.SHUT_WR)
            out.append(mod.read_hello(b, timeout_s=2.0))
        finally:
            a.close()
            b.close()
    return out


@pytest.mark.parametrize("payload", [
    struct.pack("<Q", 2) + b"{}",                       # not a hello
    struct.pack("<Q", 1 << 40),                          # oversized
    struct.pack("<Q", 5) + b"\xff\xfe\x00\x01\x02",      # not UTF-8 / JSON
    struct.pack("<Q", 7) + b"[1,2,3]",                   # JSON, not an object
    struct.pack("<Q", 50) + b"short",                    # torn
    b"\x01",                                             # torn prefix
], ids=["no-op", "oversized", "binary", "list", "torn", "prefix"])
def test_read_hello_refusals_match_the_jax_module(payload):
    mine, theirs = _hello_pair(payload)
    assert mine is None and theirs is None


def test_read_hello_accepts_a_hello_as_the_jax_module_does():
    body = b'{"op": "hello", "replica": 3, "token": "s"}'
    mine, theirs = _hello_pair(struct.pack("<Q", len(body)) + body)
    assert mine == theirs == {"op": "hello", "replica": 3, "token": "s"}


def _words(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no refusal")


def test_transport_resolution_refusals_in_the_jax_words():
    assert isinstance(tt.make_transport(None), tt.PipeTransport)
    assert isinstance(tt.make_transport("pipe"), tt.PipeTransport)
    assert tt.make_transport("pipe").name == "pipe"
    for spec, token in (("pipe", "s"), ("carrier-pigeon", None)):
        assert _words(lambda: tt.make_transport(spec, token=token)) == \
            _words(lambda: jt.make_transport(spec, token=token))
    assert _words(lambda: tt.SocketTransport(host="0.0.0.0")) == \
        _words(lambda: jt.SocketTransport(host="0.0.0.0"))
    st = tt.SocketTransport(token="t")
    js = jt.SocketTransport(token="t")
    try:
        assert tt.make_transport(st, token="t") is st
        assert _words(lambda: tt.make_transport(st, token="other")) == \
            _words(lambda: jt.make_transport(js, token="other"))
        assert st.name == "tcp" and st.connect_arg() == f"127.0.0.1:{st.port}"
    finally:
        st.close()
        js.close()
    tcp = tt.make_transport("socket")
    try:
        assert tcp.name == "tcp" and tcp.host == "127.0.0.1" and tcp.token is None
    finally:
        tcp.close()
        tcp.close()  # idempotent


def test_socket_transport_token_and_hello_refusals_over_loopback():
    st = tt.SocketTransport(token="s3cret")
    try:
        results = {}

        def accept():
            try:
                results["conn"] = st._accept(5, timeout_s=15)
            except Exception as e:  # noqa: BLE001
                results["err"] = e

        t = threading.Thread(target=accept, daemon=True)
        t.start()
        # 1) the wrong token: closed before anything is unpickled
        bad = socket.create_connection(("127.0.0.1", st.port))
        tt.write_json_frame(bad.makefile("wb"), {"op": "hello", "replica": 5,
                                                 "token": "wrong"})
        assert bad.recv(1) == b""
        bad.close()
        # 2) garbage instead of a hello: dropped the same way
        junk = socket.create_connection(("127.0.0.1", st.port))
        junk.sendall(struct.pack("<Q", 1 << 40))
        assert junk.recv(1) == b""
        junk.close()
        # 3) a pickle frame in place of the hello never reaches pickle
        evil = socket.create_connection(("127.0.0.1", st.port))
        tt.write_frame(evil.makefile("wb"), {"op": "hello", "replica": 5, "token": "s3cret"})
        assert evil.recv(1) == b""
        evil.close()
        # 4) a hello for ANOTHER replica is parked for its own spawn
        other = socket.create_connection(("127.0.0.1", st.port))
        tt.write_json_frame(other.makefile("wb"), {"op": "hello", "replica": 6,
                                                   "token": "s3cret"})
        # 5) the right hello is accepted
        good = socket.create_connection(("127.0.0.1", st.port))
        tt.write_json_frame(good.makefile("wb"), {"op": "hello", "replica": 5,
                                                  "token": "s3cret"})
        t.join(timeout=20)
        assert "conn" in results, results.get("err")
        conn = results["conn"]
        tt.write_frame(conn.makefile("wb"), {"op": "ready", "replica": 5})
        assert tt.read_frame(good.makefile("rb")) == {"op": "ready", "replica": 5}
        tt.write_frame(good.makefile("wb"), {"op": "case", "id": 9})
        assert tt.read_frame(conn.makefile("rb")) == {"op": "case", "id": 9}
        parked = st._accept(6, timeout_s=5)
        tt.write_frame(parked.makefile("wb"), {"op": "ready", "replica": 6})
        assert tt.read_frame(other.makefile("rb")) == {"op": "ready", "replica": 6}
        for s in (good, conn, other, parked):
            s.close()
        # nobody dials replica 7: the accept loop times out loudly
        with pytest.raises(TimeoutError, match="did not dial in"):
            st._accept(7, timeout_s=1.0)
    finally:
        st.close()


def test_worker_handle_reaps_and_closes_streams():
    import subprocess
    import sys

    proc = subprocess.Popen([sys.executable, "-c", "import sys; sys.stdin.read()"],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE)
    h = tt.WorkerHandle(proc, proc.stdout, proc.stdin)
    assert h.transport == "pipe"
    h.kill()
    h.reap(timeout_s=10)
    assert proc.returncode is not None and proc.stdin.closed and proc.stdout.closed
    assert h.recv_frame is not None
