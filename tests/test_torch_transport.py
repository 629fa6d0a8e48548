"""The port's socket transport for process-mode dist_ooc (DESIGN.md §13)
against the reference's ``repro.core.transport``.

* **Framing** — for every solo wire format and the multi-query panel, the
  port's frame is byte-identical to the reference's for the same entry,
  and each package parses the other's frames back to the same entry.
* **Error paths** — the reference's cases, on the port: a clean EOF at a
  frame boundary is ``None``; a short read is reassembled; a peer gone
  mid-header or mid-payload is a :class:`TransportError`; worker-local
  entries never cross the wire.
* **Corruption & partial writes** — a flipped byte at any offset of a
  frame is detected, never accepted; a corrupt frame leaves the stream in
  sync; a sender stalled mid-frame resolves into a clean frame, does not
  interleave with a concurrent send, and one closed mid-frame is a
  detected truncation.
* **Loopback parity** — two port ranks over sockets (``"device": "cpu"``)
  are bit-identical to the port's thread-mode DIST_OOC — values,
  per-iteration returns, every counter (``measured == model`` is enforced
  inside every call), per-worker totals — and equal JAX's thread mode and
  JAX's own ranks (MIN bit-equal, PageRank within 1e-5, counters equal).

The JAX package is imported inside the tests that compare with it, so
``pytest -m cuda`` loads this module on a machine without jax."""
import io
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

import torchprochelp as tph
from repro_torch.core import transport as tp
from repro_torch.core.exchange import (
    FMT_MQPANEL, FMT_PAIRS, FMT_SLAB, FMT_UVAL, FMT_VPAIRS, decode_batch,
    encode_batch, mq_decode_panel, mq_encode_panel,
)

V_MAX = 256
HEAD = dict(epoch=3, op=7, src_w=1, dst_w=2, p=5, q=0)


def _ref():
    from repro.core import transport
    return transport


def _batch(density, seed, uniform=False):
    rng = np.random.default_rng(seed)
    mask = rng.random(V_MAX) < density
    values = (rng.random(V_MAX) + 0.25).astype(np.float32)
    if uniform:
        values = np.where(mask, np.float32(7.25), 0).astype(np.float32)
    return mask, values


SOLO = [(FMT_PAIRS, 0.05, False, False), (FMT_SLAB, 0.90, False, False),
        (FMT_VPAIRS, 0.05, True, False), (FMT_UVAL, 0.10, True, True)]


def _solo_entry(expect_fmt, density, compression, uniform):
    mask, values = _batch(density, seed=expect_fmt, uniform=uniform)
    fmt, payload = encode_batch(mask, values, compression=compression)
    assert fmt == expect_fmt
    return ("wire", fmt, int(mask.sum()), payload), mask, values


def _panel_entry():
    q_cnt = 3
    rng = np.random.default_rng(11)
    masks = rng.random((q_cnt, V_MAX)) < 0.2
    masks[1, :] = False                      # empty column is skipped
    values = (rng.random((q_cnt, V_MAX)).astype(np.float32)
              * masks.astype(np.float32))
    values[2] = np.where(masks[2], np.float32(2.5), 0)  # uniform column
    union = masks.any(axis=0)
    counts = [int(m.sum()) for m in masks]
    cols, payload = mq_encode_panel(masks, values, union, counts)
    return ("wire_mq_panel", cols, int(union.sum()), payload), masks, values


# ---------------------------------------------------------------------------
# Framing: the port's frames are the reference's, both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("expect_fmt,density,compression,uniform", SOLO)
def test_frame_roundtrip_single_query(expect_fmt, density, compression,
                                      uniform):
    entry, mask, values = _solo_entry(expect_fmt, density, compression,
                                      uniform)
    frame, back = tp.frame_roundtrip(entry, **HEAD)
    assert back == entry
    assert (frame.kind, frame.epoch, frame.op, frame.src_w, frame.dst_w,
            frame.p, frame.q) == (tp.K_DATA, 3, 7, 1, 2, 5, 0)
    m2, v2 = decode_batch(back[1], back[3], back[2], V_MAX)
    np.testing.assert_array_equal(m2, mask)
    np.testing.assert_array_equal(np.where(mask, v2, 0),
                                  np.where(mask, values, 0))


def test_frame_roundtrip_mq_panel():
    entry, masks, values = _panel_entry()
    frame, back = tp.frame_roundtrip(entry, epoch=1, op=2, src_w=0,
                                     dst_w=1, p=3, q=0)
    assert frame.fmt == FMT_MQPANEL and frame.aux == len(entry[1])
    tag, cols2, u2, payload2 = back
    assert (tag, u2, payload2) == entry[:1] + entry[2:]
    assert [tuple(c) for c in cols2] \
        == [(j, c, bool(u)) for j, c, u in entry[1]]
    m2, v2 = mq_decode_panel(cols2, payload2, u2, V_MAX, 3)
    np.testing.assert_array_equal(m2, masks)
    np.testing.assert_array_equal(v2, values)


ENTRIES = [pytest.param(*case, id=f"fmt{case[0]}") for case in SOLO] + [
    pytest.param(FMT_MQPANEL, None, None, None, id="panel")]


def _entry(expect_fmt, density, compression, uniform):
    if expect_fmt == FMT_MQPANEL:
        return _panel_entry()[0]
    return _solo_entry(expect_fmt, density, compression, uniform)[0]


@pytest.mark.parametrize("expect_fmt,density,compression,uniform", ENTRIES)
def test_frames_byte_identical_to_reference(expect_fmt, density,
                                            compression, uniform):
    entry = _entry(expect_fmt, density, compression, uniform)
    ref = _ref()
    assert tp.entry_to_frame(entry, **HEAD) == \
        ref.entry_to_frame(entry, **HEAD)
    for kind, kw in ((tp.K_CTRL, dict(fmt=tp.C_RESEND_ACK, q=9,
                                      payload=b"ack")),
                     (tp.K_FAIL, dict(epoch=2, payload=b"\x80\x04")),
                     (tp.K_HEART, dict(src_w=1)), (tp.K_HELLO, {})):
        assert tp.pack_frame(kind, **kw) == ref.pack_frame(kind, **kw)
    assert (tp.HEADER_BYTES, tp._CRC_OFF) == (ref.HEADER_BYTES, ref._CRC_OFF)


@pytest.mark.parametrize("expect_fmt,density,compression,uniform", ENTRIES)
def test_each_package_parses_the_others_frames(expect_fmt, density,
                                               compression, uniform):
    entry = _entry(expect_fmt, density, compression, uniform)
    ref = _ref()
    for write, read, to_entry in (
            (tp.entry_to_frame, ref.read_frame, ref.frame_to_entry),
            (ref.entry_to_frame, tp.read_frame, tp.frame_to_entry)):
        frame = read(io.BytesIO(write(entry, **HEAD)).read)
        assert (frame.kind, frame.epoch, frame.op, frame.src_w,
                frame.dst_w, frame.p, frame.q) == (tp.K_DATA, 3, 7, 1, 2, 5, 0)
        back = to_entry(frame)
        assert back[0] == entry[0] and back[2:] == entry[2:]
        assert [tuple(c) for c in back[1]] == [tuple(c) for c in entry[1]] \
            if entry[0] == "wire_mq_panel" else back[1] == entry[1]
    # a flipped byte in the port's frame fails the reference's check
    raw = tp.entry_to_frame(entry, **HEAD)
    bad = raw[:-1] + bytes([raw[-1] ^ 0xFF])
    with pytest.raises(ref.FrameIntegrityError):
        ref.read_frame(io.BytesIO(bad).read)


# ---------------------------------------------------------------------------
# Error paths: truncation, clean EOF, non-wire entries
# ---------------------------------------------------------------------------

def test_read_exact_partial_read_raises():
    with pytest.raises(tp.TransportError, match="truncated"):
        tp.read_exact(io.BytesIO(b"abc").read, 5)
    assert tp.read_exact(io.BytesIO(b"abcde").read, 5) == b"abcde"
    assert tp.read_exact(io.BytesIO(b"").read, 0) == b""


def test_read_exact_reassembles_short_reads():
    chunks = [b"ab", b"cd", b"e"]

    def read(_n):
        return chunks.pop(0) if chunks else b""

    assert tp.read_exact(read, 5) == b"abcde"


def test_read_frame_eof_and_truncation():
    raw = tp.pack_frame(tp.K_DATA, epoch=1, op=2, src_w=0, dst_w=1,
                        payload=b"xyzw")
    assert tp.read_frame(io.BytesIO(b"").read) is None   # clean EOF
    with pytest.raises(tp.TransportError):               # partial header
        tp.read_frame(io.BytesIO(raw[:tp.HEADER_BYTES - 3]).read)
    with pytest.raises(tp.TransportError):               # short payload
        tp.read_frame(io.BytesIO(raw[:-2]).read)
    frame = tp.read_frame(io.BytesIO(raw).read)
    assert (frame.kind, frame.epoch, frame.op, frame.payload) \
        == (tp.K_DATA, 1, 2, b"xyzw")


def test_two_frames_back_to_back():
    raw = (tp.pack_frame(tp.K_DATA, op=1, payload=b"aa")
           + tp.pack_frame(tp.K_CTRL, op=2, payload=b""))
    read = io.BytesIO(raw).read
    assert tp.read_frame(read).payload == b"aa"
    assert tp.read_frame(read).kind == tp.K_CTRL
    assert tp.read_frame(read) is None


def test_local_entries_cannot_cross_the_wire():
    mask, values = _batch(0.1, seed=0)
    with pytest.raises(tp.TransportError, match="local"):
        tp.entry_to_frame(("local", mask, values), epoch=0, op=0,
                          src_w=0, dst_w=1, p=0, q=0)


# ---------------------------------------------------------------------------
# CRC: a flipped byte anywhere in the frame is detected, never accepted
# ---------------------------------------------------------------------------

def _flip(raw: bytes, off: int) -> bytes:
    return raw[:off] + bytes([raw[off] ^ 0xFF]) + raw[off + 1:]


def test_read_frame_rejects_flip_at_every_offset():
    raw = tp.pack_frame(tp.K_DATA, epoch=2, op=5, src_w=1, dst_w=0,
                        p=3, q=1, fmt=2, count=9, payload=b"0123456789abcdef")
    assert tp.read_frame(io.BytesIO(raw).read).payload \
        == b"0123456789abcdef"
    for off in range(len(raw)):
        # a CRC failure, or for a flip in the length field a detected
        # truncation: never a quietly wrong frame
        with pytest.raises(tp.TransportError):
            tp.read_frame(io.BytesIO(_flip(raw, off)).read)


def test_frame_integrity_error_names_header_fields():
    raw = tp.pack_frame(tp.K_DATA, epoch=4, op=7, src_w=2, dst_w=3,
                        p=1, q=0, payload=b"vertices")
    bad = _flip(raw, tp.HEADER_BYTES + 2)        # payload byte
    with pytest.raises(tp.FrameIntegrityError) as exc:
        tp.read_frame(io.BytesIO(bad).read)
    msg = str(exc.value)
    for field in ("op=7", "src_w=2", "dst_w=3", "checksum"):
        assert field in msg
    assert exc.value.frame.op == 7
    assert exc.value.frame.src_w == 2


def test_corrupt_frame_leaves_stream_in_sync():
    good = tp.pack_frame(tp.K_DATA, op=2, payload=b"second")
    raw = _flip(tp.pack_frame(tp.K_DATA, op=1, payload=b"first"),
                tp.HEADER_BYTES) + good
    read = io.BytesIO(raw).read
    with pytest.raises(tp.FrameIntegrityError):
        tp.read_frame(read)
    frame = tp.read_frame(read)
    assert (frame.op, frame.payload) == (2, b"second")
    assert tp.read_frame(read) is None


# ---------------------------------------------------------------------------
# Partial writes over a real socket
# ---------------------------------------------------------------------------

def _peer_pair():
    a, b = socket.socketpair()
    return tp._Peer(0, a), b, b.makefile("rb")


def test_stalled_send_resolves_into_clean_frame():
    peer, rsock, rfile = _peer_pair()
    try:
        raw = tp.pack_frame(tp.K_DATA, op=3, payload=b"x" * 64)
        t = threading.Thread(
            target=peer.send_stalled, args=(raw, len(raw) // 2, 0.2))
        t.start()
        frame = tp.read_frame(rfile.read)
        t.join()
        assert (frame.op, frame.payload) == (3, b"x" * 64)
    finally:
        peer.close()
        rsock.close()


def test_stalled_send_does_not_interleave_with_concurrent_send():
    peer, rsock, rfile = _peer_pair()
    try:
        f1 = tp.pack_frame(tp.K_DATA, op=1, payload=b"a" * 128)
        f2 = tp.pack_frame(tp.K_DATA, op=2, payload=b"b" * 32)
        t1 = threading.Thread(
            target=peer.send_stalled, args=(f1, len(f1) // 3, 0.3))
        t1.start()
        time.sleep(0.05)                 # let t1 take the send lock
        t2 = threading.Thread(target=peer.send, args=(f2,))
        t2.start()
        first = tp.read_frame(rfile.read)
        second = tp.read_frame(rfile.read)
        t1.join()
        t2.join()
        assert (first.op, first.payload) == (1, b"a" * 128)
        assert (second.op, second.payload) == (2, b"b" * 32)
    finally:
        peer.close()
        rsock.close()


@pytest.mark.parametrize("prefix_frac", [0.3, 0.8])
def test_mid_frame_close_is_detected_truncation(prefix_frac):
    peer, rsock, rfile = _peer_pair()
    try:
        raw = tp.pack_frame(tp.K_DATA, op=9, payload=b"y" * 50)
        peer.send(raw[:int(len(raw) * prefix_frac)])
        peer.close()
        with pytest.raises(tp.TransportError, match="truncated"):
            tp.read_frame(rfile.read)
    finally:
        peer.close()
        rsock.close()


def test_stall_check_spares_a_peer_with_unread_bytes():
    """A peer silent past ``stall_timeout`` is dead only when nothing of
    it waits unread: bytes in the socket mean this side's receiver thread
    has not run, not that the peer stalled."""
    mesh = tp.ProcMesh(0, 1, "unused", stall_timeout=0.05)
    a, b = socket.socketpair()
    try:
        peer = mesh.peers[1] = tp._Peer(1, a)
        peer.last_recv -= 10.0
        b.sendall(tp.pack_frame(tp.K_HEART, src_w=1))
        mesh.check_stalls([1])
        assert peer.alive and 1 not in mesh.dead
        assert tp.read_frame(peer.rfile.read).kind == tp.K_HEART
        peer.last_recv -= 10.0
        mesh.check_stalls([1])
        assert not peer.alive and 1 in mesh.dead
    finally:
        mesh.close()
        b.close()


def test_a_quiet_peer_outlives_the_connect_timeout(tmp_path):
    """Rank 1 dials rank 0 with a connect timeout of at most 5 s; the
    dialed socket must not keep it.  At a stall timeout of 120 s the
    heartbeats come every 30 s, and with the timeout kept rank 1's
    receiver raised after 5 s of silence from a live rank 0 and declared
    it dead (the intermittent ``proc_path`` failure: ``transport link
    lost: ... TimeoutError``).  Both ranks stay alive through 6 s of
    silence, and every link blocks."""
    meshes = {}

    def make(r):
        meshes[r] = tp.ProcMesh(r, 2, str(tmp_path), connect_timeout=30.0,
                                stall_timeout=120.0)
    threads = [threading.Thread(target=make, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60.0)
    try:
        assert sorted(meshes) == [0, 1]
        socks = [p.sock for m in meshes.values() for p in m.peers.values()]
        assert len(socks) == 2
        assert all(s.gettimeout() is None for s in socks)
        time.sleep(6.0)
        for m in meshes.values():
            assert not m.dead and all(p.alive for p in m.peers.values())
    finally:
        for m in meshes.values():
            m.close()


def test_a_link_lost_with_an_error_is_reported(capsys):
    """A peer whose link fails with an error (here it closes mid-frame)
    is marked dead with one ``transport link lost:`` line on stderr
    naming the error; a clean EOF at a frame boundary (a peer's normal
    exit) writes nothing."""
    mesh = tp.ProcMesh(0, 1, "unused", stall_timeout=60.0)
    pairs = [socket.socketpair() for _ in range(2)]
    try:
        for r, ((a, b), cut) in enumerate(zip(pairs, (True, False)), 1):
            peer = mesh.peers[r] = tp._Peer(r, a)
            raw = tp.pack_frame(tp.K_DATA, op=4, payload=b"z" * 64)
            b.sendall(raw[:len(raw) // 2] if cut else raw)
            b.close()
            t = threading.Thread(target=mesh._recv_loop, args=(peer,),
                                 daemon=True)
            t.start()
            t.join(10.0)
            assert not peer.alive and r in mesh.dead
        lines = [ln for ln in capsys.readouterr().err.splitlines()
                 if ln.startswith("transport link lost: ")]
        (line,) = lines
        rep = json.loads(line.split("transport link lost: ", 1)[1])
        assert (rep["rank"], rep["peer"], rep["where"]) == (0, 1, "read")
        assert rep["error"].startswith("TransportError: truncated frame")
    finally:
        mesh.close()


def test_stall_report_names_the_reader_state(capsys):
    """A peer declared dead for a stall leaves one report, kept on the
    mesh and written to stderr: silence, the receiver's reader state
    (here blocked mid-frame, waiting for the payload), frames and bytes
    read, and this rank's own heartbeat age."""
    mesh = tp.ProcMesh(0, 1, "unused", stall_timeout=0.05)
    a, b = socket.socketpair()
    try:
        peer = mesh.peers[1] = tp._Peer(1, a)
        raw = tp.pack_frame(tp.K_DATA, op=4, payload=b"z" * 64)
        b.sendall(raw[:len(raw) // 2])
        t = threading.Thread(target=lambda: pytest.raises(
            tp.TransportError, tp.read_frame, peer.read), daemon=True)
        peer.thread = t
        t.start()
        deadline = time.monotonic() + 10.0
        while not (peer.rx_want and peer.rx_bytes and not peer.readable()):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        peer.last_recv -= 10.0
        mesh.check_stalls([1])
        assert not peer.alive and 1 in mesh.dead
        (rep,) = mesh.stall_reports
        assert (rep["rank"], rep["peer"], rep["rx_frames"]) == (0, 1, 0)
        assert rep["silent_s"] >= 10.0 and rep["stall_timeout"] == 0.05
        assert 0 < rep["rx_bytes"] < len(raw) and rep["rx_want"] > 0
        assert rep["receiver_alive"] and not rep["send_lock_held"]
        assert rep["own_heartbeat_age_s"] >= 0
        line = capsys.readouterr().err.strip().splitlines()[-1]
        assert json.loads(line.split("transport stall: ", 1)[1]) == \
            json.loads(json.dumps(rep))
    finally:
        b.close()
        t.join(10.0)
        mesh.close()


# ---------------------------------------------------------------------------
# Loopback parity: port ranks == port threads == JAX, bit for bit
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def prob(tmp_path_factory):
    return tph.build_problem(str(tmp_path_factory.mktemp("tproc")),
                             workers=(2,))


@pytest.fixture(scope="module")
def jprob(tmp_path_factory):
    import prochelp
    return prochelp.build_problem(str(tmp_path_factory.mktemp("jproc")),
                                  workers=(2,))


@pytest.mark.parametrize("algname", ["pagerank", "bfs"])
def test_loopback_process_parity(prob, jprob, tmp_path, algname):
    import prochelp
    base = tph.run_threads(prob, 2, algname)
    spec, codes, results = tph.run_procs(prob, 2, algname,
                                         str(tmp_path / "port"))
    assert codes == [0, 0], (tph.rank_log(spec, 0), tph.rank_log(spec, 1))
    for r in (0, 1):
        tph.assert_result_equal(results[r], base)
        assert int(results[r]["recoveries"]) == 0
        assert int(results[r]["epoch"]) == 0
        np.testing.assert_array_equal(results[r]["dropped"], 0)
        np.testing.assert_array_equal(results[r]["late_delivered"], 0)
    # cross-rank batches crossed sockets: with W = world = 2 rank r only
    # ever sends from its own worker r to the other
    assert results[0]["wire_frames"][0, 1] > 0
    assert results[1]["wire_frames"][1, 0] > 0
    assert results[0]["wire_frames"][1].sum() == 0
    assert results[1]["wire_frames"][0].sum() == 0
    # and the port equals JAX's thread mode and JAX's own ranks
    tph.assert_matches_jax(results[0], prochelp.run_threads(jprob, 2,
                                                            algname),
                           algname)
    _, jcodes, jresults = prochelp.run_procs(jprob, 2, algname,
                                             str(tmp_path / "jax"))
    assert jcodes == [0, 0]
    tph.assert_matches_jax(results[0], jresults[0], algname)


def test_a_loaded_host_does_not_silence_a_rank(prob, tmp_path):
    """Two ranks' PageRank with the fault tests' ``stall_timeout`` (1.5 s)
    while as many spinning processes as the host has cores compete for
    it: no rank is declared dead, none writes a stall report, and the
    values equal the threads' run.  CPU oversubscription alone does not
    starve a rank's heartbeat and receiver threads for a stall timeout."""
    base = tph.run_threads(prob, 2, "pagerank")
    hogs = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
            for _ in range(os.cpu_count() or 1)]
    try:
        spec, codes, results = tph.run_procs(
            prob, 2, "pagerank", str(tmp_path / "run"), stall_timeout=1.5)
    finally:
        for h in hogs:
            h.kill()
            h.wait()
    logs = [tph.rank_log(spec, r) for r in (0, 1)]
    assert codes == [0, 0], logs
    assert not any("transport stall" in log for log in logs), logs
    for r in (0, 1):
        tph.assert_result_equal(results[r], base)
        assert int(results[r]["recoveries"]) == 0


def test_socket_bytes_are_the_measured_wire(prob):
    """Every priced wire byte either crossed a socket as a DATA frame's
    payload or passed between two workers of one rank: summed over the
    ranks, the two equal ``measured_net_bytes`` (W = 4 on two ranks, so
    both kinds occur)."""
    from repro_torch.core import ChunkStore
    root = tempfile.mkdtemp(dir=os.path.dirname(prob["stores"][2].root))
    store = ChunkStore.build_sharded(prob["dg"], prob["fm"],
                                     f"{root}/w4", 4)
    prob4 = dict(prob, stores={4: store})
    spec = tph.proc_spec(prob4, 4, "bfs", f"{root}/run", world=2)
    job = _run_in_threads(spec, prob4)
    c = job[0]["out"]
    names = [str(n) for n in c["counter_names"]]
    measured = c["counter_vals"][names.index("measured_net_bytes")]
    socket_b = sum(j["ctx"].stats["socket_payload_bytes"] for j in job)
    local_b = sum(j["ctx"].stats["rank_local_wire_bytes"] for j in job)
    assert socket_b > 0 and local_b > 0
    assert socket_b + local_b == measured
    tph.assert_result_equal(c, tph.run_threads(prob4, 4, "bfs"))


def _run_in_threads(spec, prob):
    """Two ranks of one job as threads of this process (the transport
    does not care), returning each rank's ``run_rank`` result."""
    from repro_torch.runtime.procworker import run_rank
    os.makedirs(spec["rendezvous"], exist_ok=True)
    os.makedirs(spec["result_dir"], exist_ok=True)
    out, errs = {}, []

    def body(r):
        try:
            out[r] = run_rank(spec, r, prob["spec"], prob["dg"], prob["fm"])
        except BaseException as exc:       # noqa: BLE001 — re-raised below
            errs.append(exc)

    threads = [threading.Thread(target=body, args=(r,))
               for r in range(spec["world"])]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    if errs:
        raise errs[0]
    for j in out.values():
        j["ctx"].finalize()
    return [out[r] for r in range(spec["world"])]


# ---------------------------------------------------------------------------
# Two ranks on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_two_ranks_on_the_card(cuda_device, prob, tmp_path):
    """Two ranks share the card (no ``"device"``: the GPU, block_csr, the
    fused decode and the wire's kernels): bit-equal to the same job on the
    CPU for BFS, PageRank within 1e-5 of it.  The kernels are built here
    first, as the smoke does, so the ranks only load them."""
    from repro_torch.kernels import chunk_decode, csr_spmv, varint
    csr_spmv._library()
    varint._library()
    chunk_decode._library()
    for algname in ("bfs", "pagerank"):
        cpu = tph.run_threads(prob, 2, algname)
        spec = tph.proc_spec(prob, 2, algname, str(tmp_path / algname),
                             engine={"compute_backend": "block_csr"})
        del spec["device"]
        from repro_torch.runtime.procworker import launch
        codes = launch(spec, timeout=600)
        assert codes == [0, 0], (tph.rank_log(spec, 0),
                                 tph.rank_log(spec, 1))
        res = tph.results_of(spec, codes)[0]
        if algname == "bfs":
            tph.assert_result_equal(res, cpu, keys=("values", "iterations",
                                                    "rets"))
        else:
            np.testing.assert_allclose(res["values"], cpu["values"],
                                       rtol=1e-5, atol=1e-7)
