"""The port's storage audits and peer storage vs the JAX package's: the
non-network cases of ``tests/test_audit.py`` through both packages, then
cross-package cases -- equal challenge tables and proofs under one seeded
``rand``, equal obfuscated shard files from ``ReceivedFilesWriter``, equal
restore trees from ``RestoreFilesWriter``, equal ledger schedules and
retry policies.

The port proves and builds tables with ``GpuBackend(device="cpu")`` (the
plain BLAKE3 leaf kernel); the reference with its ``CpuBackend``.
"""

import asyncio
import random
from dataclasses import replace
from types import SimpleNamespace

import pytest

from backuwup_tpu import audit as ref_audit
from backuwup_tpu import defaults as ref_defaults
from backuwup_tpu import wire as ref_wire
from backuwup_tpu.audit import challenge as ref_challenge
from backuwup_tpu.audit import prover as ref_prover
from backuwup_tpu.crypto import KeyManager as RefKeyManager
from backuwup_tpu.net import p2p as ref_p2p
from backuwup_tpu.obs import metrics as ref_metrics
from backuwup_tpu.ops.backend import CpuBackend as RefCpuBackend
from backuwup_tpu.ops.gear import CDCParams as RefCDCParams
from backuwup_tpu.snapshot.blob_index import ChallengeTable as RefTable
from backuwup_tpu.store import Store as RefStore
from backuwup_tpu.utils import faults as ref_faults
from backuwup_tpu.utils import retry as ref_retry
from backuwup_tpu_torch import audit, defaults, wire
from backuwup_tpu_torch.audit import challenge, prover
from backuwup_tpu_torch.crypto import KeyManager
from backuwup_tpu_torch.net import p2p
from backuwup_tpu_torch.obs import metrics
from backuwup_tpu_torch.ops.backend import GpuBackend
from backuwup_tpu_torch.ops.gear import CDCParams
from backuwup_tpu_torch.snapshot.blob_index import ChallengeTable
from backuwup_tpu_torch.store import Store
from backuwup_tpu_torch.utils import faults, retry

SECRET = b"\x21" * 32
VERIFIER = b"\x07" * 32  # verifier client id
PID = b"\x42" * 12

PKGS = {
    "port": SimpleNamespace(
        name="port", audit=audit, challenge=challenge, prover=prover,
        defaults=defaults, wire=wire, p2p=p2p, Store=Store,
        Table=ChallengeTable, keys=KeyManager.from_secret(SECRET),
        backend=GpuBackend(CDCParams.from_desired(4096), device="cpu")),
    "ref": SimpleNamespace(
        name="ref", audit=ref_audit, challenge=ref_challenge,
        prover=ref_prover, defaults=ref_defaults, wire=ref_wire, p2p=ref_p2p,
        Store=RefStore, Table=RefTable,
        keys=RefKeyManager.from_secret(SECRET),
        backend=RefCpuBackend(RefCDCParams.from_desired(4096))),
}


def _rng_bytes(n, seed=5):
    return random.Random(seed).randbytes(n)


@pytest.fixture(autouse=True)
def _isolate():
    for reg in (metrics, ref_metrics):
        reg.registry().reset()
    yield
    for reg in (metrics, ref_metrics):
        reg.registry().reset()
    faults.uninstall()
    ref_faults.uninstall()


@pytest.fixture(params=["port", "ref"])
def pkg(request):
    return PKGS[request.param]


@pytest.fixture
def store(pkg, tmp_path):
    s = pkg.Store(tmp_path / "cfg", data_base=tmp_path / "data")
    s.set_obfuscation_key(b"\xaa\x01\x7f\x33")
    yield s
    s.close()


def _install_packfile(pkg, store, verifier, pid, raw):
    """Store ``raw`` the way ReceivedFilesWriter would: obfuscated."""
    d = store.received_dir(verifier) / "pack"
    d.mkdir(parents=True, exist_ok=True)
    path = d / bytes(pid).hex()
    path.write_bytes(pkg.p2p.obfuscate(raw, store.get_obfuscation_key()))
    return path


# --------------------------------------------------------------------------
# challenge construction + table persistence
# --------------------------------------------------------------------------


def test_sample_windows_stay_in_bounds(pkg):
    rng = random.Random(3)
    for size in (1, 100, 65536, 300_000):
        for off, ln in pkg.challenge.sample_windows(size, 50,
                                                    rand=rng.randbytes):
            assert 0 <= off and off + ln <= size
            assert ln == min(pkg.defaults.AUDIT_WINDOW_BYTES, size)
    with pytest.raises(ValueError):
        pkg.challenge.sample_windows(0, 4)


def test_challenge_table_roundtrip_and_write_once(pkg, tmp_path):
    data = _rng_bytes(200_000)
    entries = pkg.audit.build_challenge_table(pkg.backend, data, count=6)
    assert len(entries) == 6
    assert len({e.nonce for e in entries}) == 6  # fresh nonce per entry
    tables = pkg.Table(pkg.keys, tmp_path)
    tables.save(PID, entries)
    assert tables.has(PID)
    assert tables.load(PID) == entries
    with pytest.raises(FileExistsError):
        tables.save(PID, entries)


def test_detection_probability_math(pkg):
    p = pkg.audit.detection_probability
    assert p(0.0, 16) == 0.0
    assert p(1.0, 1) == 1.0
    assert p(0.01, 16) == pytest.approx(0.1485, abs=1e-3)
    assert p(0.1, 8) > 0.56
    assert p(0.03, 8) == ref_audit.detection_probability(0.03, 8)


# --------------------------------------------------------------------------
# prover
# --------------------------------------------------------------------------


def test_deobfuscate_window_at_unaligned_offsets(pkg):
    key = b"\x13\x9e\x00\xf7"
    raw = _rng_bytes(1000)
    stream = pkg.p2p.obfuscate(raw, key)
    assert stream == ref_p2p.obfuscate(raw, key)
    for off, ln in ((0, 100), (1, 37), (2, 500), (3, 997), (777, 223)):
        assert pkg.prover.deobfuscate_window(stream[off:off + ln], key,
                                             off) == raw[off:off + ln]


def test_prover_honest_proofs_match_table(pkg, store):
    raw = _rng_bytes(150_000)
    entries = pkg.audit.build_challenge_table(pkg.backend, raw, count=5)
    _install_packfile(pkg, store, VERIFIER, PID, raw)
    wired = pkg.challenge.to_wire(PID, entries)
    proofs = pkg.audit.compute_proofs(store, pkg.backend, VERIFIER, wired)
    ok = pkg.wire.ProofStatus.OK
    assert [p.status for p in proofs] == [ok] * 5
    assert [bytes(p.digest) for p in proofs] == [e.digest for e in entries]
    result = pkg.audit.check_proofs(wired, [e.digest for e in entries],
                                    proofs)
    assert result.passed and result.checked == 5


def test_prover_admits_missing_and_truncated(pkg, store):
    raw = _rng_bytes(150_000)
    entries = pkg.audit.build_challenge_table(pkg.backend, raw, count=4)
    path = _install_packfile(pkg, store, VERIFIER, PID, raw)
    challenges = pkg.challenge.to_wire(PID, entries)
    expected = [e.digest for e in entries]
    status = pkg.wire.ProofStatus

    path.write_bytes(path.read_bytes()[:1000])
    proofs = pkg.audit.compute_proofs(store, pkg.backend, VERIFIER,
                                      challenges)
    assert all(p.status in (status.SHORT, status.OK) for p in proofs)
    assert any(p.status == status.SHORT for p in proofs)
    verdict = pkg.audit.check_proofs(challenges, expected, proofs)
    assert not verdict.passed and "short" in verdict.detail

    path.unlink()
    proofs = pkg.audit.compute_proofs(store, pkg.backend, VERIFIER,
                                      challenges)
    assert [p.status for p in proofs] == [status.MISSING] * 4
    verdict = pkg.audit.check_proofs(challenges, expected, proofs)
    assert not verdict.passed and "missing" in verdict.detail


def test_check_proofs_rejects_count_mismatch_and_bad_digest(pkg):
    data = _rng_bytes(80_000)
    entries = pkg.audit.build_challenge_table(pkg.backend, data, count=3)
    challenges = pkg.challenge.to_wire(PID, entries)
    expected = [e.digest for e in entries]
    ok = [pkg.wire.StorageProof(packfile_id=PID,
                                status=pkg.wire.ProofStatus.OK,
                                digest=e.digest) for e in entries]
    assert pkg.audit.check_proofs(challenges, expected, ok).passed
    assert not pkg.audit.check_proofs(challenges, expected, ok[:2]).passed
    forged = ok[:2] + [replace(ok[2], digest=b"\x00" * 32)]
    verdict = pkg.audit.check_proofs(challenges, expected, forged)
    assert not verdict.passed and "digest mismatch" in verdict.detail


# --------------------------------------------------------------------------
# verifier selection: single-use cursor
# --------------------------------------------------------------------------


def test_select_challenges_burns_cursor_and_exhausts(pkg, store, tmp_path):
    raw = _rng_bytes(100_000)
    tables = pkg.Table(pkg.keys, tmp_path / "tables")
    tables.save(PID, pkg.audit.build_challenge_table(pkg.backend, raw,
                                                     count=5))
    peer = b"\x50" * 32
    store.record_placement(PID, peer, len(raw))

    first, exp1 = pkg.audit.select_challenges(store, tables, peer, samples=3)
    second, exp2 = pkg.audit.select_challenges(store, tables, peer,
                                                samples=3)
    assert len(first) == 3 and len(second) == 2  # table holds only 5
    seen = {(c.offset, c.nonce) for c in first}
    assert not seen & {(c.offset, c.nonce) for c in second}
    assert pkg.audit.select_challenges(store, tables, peer) == ([], [])


# --------------------------------------------------------------------------
# ledger policy
# --------------------------------------------------------------------------


def test_ledger_miss_demotion_threshold_and_backoff(pkg, store):
    peer = b"\x61" * 32
    t0 = 1_000_000.0
    d = pkg.defaults
    st = pkg.audit.record_miss(store, peer, now=t0)
    assert not st.demoted and st.misses == 1
    assert st.next_due == t0 + d.AUDIT_RETRY_BASE_S
    st = pkg.audit.record_miss(store, peer, now=t0)
    assert not st.demoted
    assert st.next_due == t0 + 2 * d.AUDIT_RETRY_BASE_S  # backoff
    st = pkg.audit.record_miss(store, peer, now=t0)  # 3rd: demoted
    assert st.demoted and st.consecutive_misses == d.AUDIT_DEMOTE_MISSES
    st = pkg.audit.record_pass(store, peer, now=t0)
    assert not st.demoted and st.consecutive_misses == 0
    assert st.next_due == t0 + d.AUDIT_INTERVAL_S


def test_ledger_single_failure_demotes_and_excludes_peer(pkg, store):
    peer = b"\x62" * 32
    store.add_peer_negotiated(peer, 1 << 20)
    assert any(bytes(p.pubkey) == peer
               for p in store.find_peers_with_storage())
    st = pkg.audit.record_fail(store, peer, "digest mismatch", now=2.0)
    assert st.demoted and st.failures == 1
    assert "digest mismatch" in st.last_result
    assert peer in {bytes(p) for p in store.demoted_peers()}
    assert all(bytes(p.pubkey) != peer
               for p in store.find_peers_with_storage())


def test_audit_due_scheduling(pkg, store):
    peer = b"\x63" * 32
    store.record_placement(PID, peer, 1000, now=1.0)
    assert peer in [bytes(p) for p in store.audit_due_peers(now=2.0)]
    pkg.audit.record_pass(store, peer, now=2.0)
    assert store.audit_due_peers(now=3.0) == []
    store.mark_audit_due(peer, now=3.0)
    assert peer in [bytes(p) for p in store.audit_due_peers(now=3.0)]


# --------------------------------------------------------------------------
# cross-package: tables, proofs, stored bytes, schedules
# --------------------------------------------------------------------------


def test_tables_and_proofs_equal_under_one_seeded_rand(tmp_path):
    """Both packages build the table of a packfile and of a 13-byte shard
    id with ``rand`` drawn from one seed: equal entries and table files;
    each package loads the other's file, and proves from a store the
    other wrote, with equal proofs."""
    raw = _rng_bytes(300_001, seed=9)
    sid = PID + b"\x03"
    out = {}
    for name, pkg in PKGS.items():
        entries = pkg.audit.build_challenge_table(
            pkg.backend, raw, count=defaults.AUDIT_CHALLENGES_PER_PACKFILE,
            rand=random.Random(77).randbytes)
        tables = pkg.Table(pkg.keys, tmp_path / name / "tables")
        paths = [tables.save(i, entries) for i in (PID, sid)]
        out[name] = (entries, [p.read_bytes() for p in paths])
    (port_e, port_files), (ref_e, ref_files) = out["port"], out["ref"]
    assert [vars(e) for e in port_e] == [vars(e) for e in ref_e]
    assert port_files == ref_files
    assert RefTable(PKGS["ref"].keys, tmp_path / "port" / "tables").load(
        sid) == ref_e
    assert ChallengeTable(PKGS["port"].keys,
                          tmp_path / "ref" / "tables").load(sid) == port_e

    # the prover's store: written by one package, proved by both
    s = RefStore(tmp_path / "cfg", data_base=tmp_path / "data")
    s.set_obfuscation_key(b"\x5a\xa5\x0f\xf0")
    d = s.received_dir(VERIFIER) / "shard"
    d.mkdir(parents=True)
    (d / sid.hex()).write_bytes(ref_p2p.obfuscate(raw, b"\x5a\xa5\x0f\xf0"))
    s.close()
    proofs = {}
    for name, pkg in PKGS.items():
        st = pkg.Store(tmp_path / "cfg", data_base=tmp_path / "data")
        try:
            proofs[name] = pkg.audit.compute_proofs(
                st, pkg.backend, VERIFIER,
                pkg.challenge.to_wire(sid, port_e))
        finally:
            st.close()
    assert [(p.status.name, bytes(p.digest)) for p in proofs["port"]] == \
        [(p.status.name, bytes(p.digest)) for p in proofs["ref"]]
    assert audit.check_proofs(challenge.to_wire(sid, port_e),
                              [e.digest for e in port_e],
                              proofs["port"]).passed


def test_received_and_restore_writers_lay_out_equal_bytes(tmp_path):
    """``ReceivedFilesWriter`` stores equal obfuscated bytes at equal
    paths in both packages, refuses a different payload under the same id
    and a file over the quota, and acks an identical re-send;
    ``RestoreFilesWriter`` lays out equal trees; ``iter_stored`` reads
    back the other package's files."""
    peer = b"\x90" * 32
    sid = PID + b"\x05"
    data = _rng_bytes(70_003, seed=2)
    for name, pkg in PKGS.items():
        st = pkg.Store(tmp_path / name / "cfg",
                       data_base=tmp_path / name / "data")
        st.set_obfuscation_key(b"\x10\x20\x30\x40")
        st.add_peer_negotiated(peer, 100_000)
        w = pkg.p2p.ReceivedFilesWriter(st, peer)
        kinds = pkg.wire.FileInfoKind

        async def run():
            await w.sink(kinds.SHARD, sid, data)
            await w.sink(kinds.SHARD, sid, data)  # idempotent re-send
            with pytest.raises(pkg.p2p.P2PError, match="overwrite"):
                await w.sink(kinds.SHARD, sid, data[:-1])
            with pytest.raises(pkg.p2p.P2PError, match="quota"):
                await w.sink(kinds.PACKFILE, PID, b"\x00" * (
                    100_000 + defaults.PEER_OVERUSE_GRACE))
            rw = pkg.p2p.RestoreFilesWriter(st, tmp_path / name / "restore")
            await rw.sink(kinds.SHARD, sid, data)
            await rw.sink(kinds.PACKFILE, PID, data[:999])
            await rw.sink(kinds.INDEX, (7).to_bytes(8, "little"), b"idx")
            assert rw.files == 3

        asyncio.run(run())
        assert st.get_peer(peer).bytes_received == len(data)
        st.close()
    for rel in (f"data/received_packfiles/{peer.hex()}/shard/{sid.hex()}",
                f"restore/shard/{PID.hex()}/005",
                f"restore/pack/{PID.hex()[:2]}/{PID.hex()}",
                "restore/index/000007"):
        assert (tmp_path / "port" / rel).read_bytes() == \
            (tmp_path / "ref" / rel).read_bytes(), rel
    # each package's writer reads back the other's stored files
    for reader, other in (("port", "ref"), ("ref", "port")):
        pkg = PKGS[reader]
        st = pkg.Store(tmp_path / other / "cfg",
                       data_base=tmp_path / other / "data")
        stored = list(pkg.p2p.ReceivedFilesWriter(st, peer).iter_stored())
        st.close()
        assert [(k.name, i, d) for k, i, d in stored] == \
            [("SHARD", sid, data)]


def test_partial_store_stages_equal_files(tmp_path):
    """Chunked transfer staging: equal bin/json files part by part, the
    same resume offer and the same verified assembly in both packages."""
    from backuwup_tpu_torch.ops.blake3_cpu import blake3_many

    data = _rng_bytes(10_000, seed=4)
    digest = blake3_many([data])[0]
    fid = PID + b"\x01"
    for name, pkg in PKGS.items():
        ps = pkg.p2p.PartialStore(tmp_path / name)
        kind = pkg.wire.FileInfoKind.SHARD
        assert ps.append(kind, fid, 0, len(data), digest, data[:4000]) is None
        held, dg, prefix = ps.query(fid)
        assert (held, dg, prefix) == (4000, digest,
                                      blake3_many([data[:4000]])[0])
        with pytest.raises(pkg.p2p.P2PError, match="non-contiguous"):
            ps.append(kind, fid, 3000, len(data), digest, data[3000:4000])
    for suffix in (".bin", ".json"):
        assert (tmp_path / "port" / f"{fid.hex()}{suffix}").read_bytes() == \
            (tmp_path / "ref" / f"{fid.hex()}{suffix}").read_bytes()
    for name, pkg in PKGS.items():
        ps = pkg.p2p.PartialStore(tmp_path / name)
        out = ps.append(pkg.wire.FileInfoKind.SHARD, fid, 4000, len(data),
                        digest, data[4000:])
        assert out == data and ps.query(fid) == (0, b"", b"")
        assert ps.expire(ttl_s=0.0, now=1e12) == 0  # nothing left


def test_ledger_schedules_and_retry_policies_equal():
    """The ledger's persisted schedule and every retry policy equal the
    reference's; a backoff's attempts count in the port's own registry."""
    for name in ("DIAL", "WS_RECONNECT", "STORAGE_REQUEST", "SEND_IDLE",
                 "PEER_WAIT", "AUDIT"):
        assert vars(getattr(retry, name)) == vars(getattr(ref_retry, name))
    for attempt in range(1, 30):
        assert retry.AUDIT.delay_s(attempt) == \
            ref_retry.AUDIT.delay_s(attempt)
        assert retry.DIAL.delay_s(attempt, lambda: 0.25) == \
            ref_retry.DIAL.delay_s(attempt, lambda: 0.25)
    b = retry.Backoff(retry.DIAL, rand=lambda: 0.5)
    delays = [b.next_delay() for _ in range(4)]
    assert delays == [0.5, 1.0, None, None]
    port_count = metrics.registry().get("bkw_retry_attempts_total")
    ref_count = ref_metrics.registry().get("bkw_retry_attempts_total")
    assert port_count.value(policy="dial") == 2
    assert ref_count.value(policy="dial") == 0


def test_ledger_states_equal_across_packages(tmp_path):
    peer = b"\x64" * 32
    states = {}
    for name, pkg in PKGS.items():
        st = pkg.Store(tmp_path / name)
        seq = [pkg.audit.record_miss(st, peer, now=10.0),
               pkg.audit.record_miss(st, peer, now=20.0),
               pkg.audit.record_fail(st, peer, "short", now=30.0),
               pkg.audit.record_pass(st, peer, now=40.0),
               pkg.audit.record_fail(st, peer, now=50.0)]
        states[name] = [vars(s) for s in seq]
        st.close()
    assert states["port"] == states["ref"]
