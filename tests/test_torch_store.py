"""The port's client store vs the JAX package's: the cases of
``tests/test_store.py`` through both packages, and each package opening a
database the other wrote (placements, audit ledger, peer stats, snapshots,
the event log and the KV config)."""

import pytest

from backuwup_tpu import store as ref_store_mod
from backuwup_tpu.utils import tracing as ref_tracing
from backuwup_tpu_torch import store as store_mod
from backuwup_tpu_torch.utils import tracing

PACKAGES = {"port": store_mod, "ref": ref_store_mod}


@pytest.fixture(params=["port", "ref"])
def pkg(request):
    return PACKAGES[request.param]


@pytest.fixture
def store(pkg, tmp_path):
    s = pkg.Store(tmp_path / "cfg")
    yield s
    s.close()


def test_identity_round_trip(store):
    assert store.get_root_secret() is None
    assert not store.is_initialized()
    store.set_root_secret(b"\x07" * 32)
    store.set_auth_token(b"\x01" * 16)
    store.set_obfuscation_key(b"\xaa\xbb\xcc\xdd")
    store.set_initialized()
    assert store.get_root_secret() == b"\x07" * 32
    assert store.get_auth_token() == b"\x01" * 16
    assert store.get_obfuscation_key() == b"\xaa\xbb\xcc\xdd"
    assert store.is_initialized()
    store.set_auth_token(None)
    assert store.get_auth_token() is None


def test_obfuscation_key_length_checked(store):
    with pytest.raises(ValueError):
        store.set_obfuscation_key(b"\x01" * 5)


def test_backup_config(store):
    assert store.get_backup_path() is None
    store.set_backup_path("/data/stuff")
    assert store.get_backup_path() == "/data/stuff"
    assert store.get_highest_sent_index() == -1
    store.set_highest_sent_index(17)
    assert store.get_highest_sent_index() == 17
    store.set_highest_sent_index(3)  # monotonic watermark
    assert store.get_highest_sent_index() == 17


def test_peer_ledger_accounting(store):
    a, b = b"\x01" * 32, b"\x02" * 32
    store.add_peer_negotiated(a, 1000)
    store.add_peer_negotiated(a, 500)   # upsert-increment
    store.add_peer_negotiated(b, 2000)
    store.add_peer_transmitted(a, 300)
    store.add_peer_received(b, 100)
    pa, pb = store.get_peer(a), store.get_peer(b)
    assert pa.bytes_negotiated == 1500 and pa.bytes_transmitted == 300
    assert pa.free_storage == 1200
    assert pb.bytes_received == 100 and pb.free_storage == 2000
    assert [p.pubkey for p in store.find_peers_with_storage()] == [b, a]


def test_peer_bump_creates_row(store):
    store.add_peer_transmitted(b"\x09" * 32, 42)
    assert store.get_peer(b"\x09" * 32).bytes_transmitted == 42


def test_event_log(pkg, store):
    assert store.last_event_time(pkg.EVENT_RESTORE_REQUEST) is None
    store.add_event(pkg.EVENT_RESTORE_REQUEST, {}, now=100.0)
    store.add_event(pkg.EVENT_RESTORE_REQUEST, {}, now=200.0)
    assert store.last_event_time(pkg.EVENT_RESTORE_REQUEST) == 200.0
    assert store.last_backup_size() is None
    store.add_event(pkg.EVENT_BACKUP, {"size": 12345}, now=300.0)
    assert store.last_backup_size() == 12345


def test_persistence_across_reopen(pkg, tmp_path):
    s = pkg.Store(tmp_path / "cfg")
    s.set_root_secret(b"\x03" * 32)
    s.add_peer_negotiated(b"\x04" * 32, 777)
    s.close()
    s2 = pkg.Store(tmp_path / "cfg")
    assert s2.get_root_secret() == b"\x03" * 32
    assert s2.get_peer(b"\x04" * 32).bytes_negotiated == 777
    s2.close()


@pytest.mark.parametrize("trace", [tracing, ref_tracing],
                         ids=["port", "ref"])
def test_tracing_spans_and_report(trace):
    trace.reset()
    trace.enable(True)
    try:
        with trace.span("unit.test"):
            pass

        @trace.traced("unit.decorated")
        def f():
            return 41

        assert f() == 41
        rep = trace.report()
        assert rep["unit.test"][0] == 1
        assert rep["unit.decorated"][0] == 1
        assert "unit.test" in trace.format_report()
    finally:
        trace.enable(False)
        trace.reset()
    with trace.span("unit.off"):
        pass
    assert "unit.off" not in trace.report()


# --------------------------------------------------------------------------
# each package opens the other's database
# --------------------------------------------------------------------------


def _fill(pkg, s):
    """Every table a stripe, audit or restore path writes."""
    s.set_root_secret(b"\x11" * 32)
    s.set_obfuscation_key(b"\x01\x02\x03\x04")
    s.set_backup_path("/home/u")
    s.set_highest_sent_index(9)
    s.set_audit_cursor(b"\x22" * 13, 5)
    peers = [bytes([p]) * 32 for p in range(1, 7)]
    for n, p in enumerate(peers):
        s.add_peer_negotiated(p, 10_000 + n, now=50.0 + n)
        s.add_peer_transmitted(p, 100 * n)
        s.record_placement(b"\x22" * 12, p, 1234, now=60.0 + n,
                           shard_index=n)
    s.record_placement(b"\x33" * 12, peers[0], 999, now=70.0)
    s.put_audit_state(pkg.AuditState(
        peer=peers[1], passes=3, failures=1, misses=2,
        consecutive_failures=1, consecutive_misses=0, demoted=True,
        last_result="fail: digest mismatch", last_audit=80.0,
        next_due=140.0))
    s.put_peer_stats(pkg.PeerStatsRow(peer=peers[2], throughput_bps=1e6,
                                      latency_s=0.01, success=0.9,
                                      samples=7, updated=90.0))
    s.record_snapshot(b"\x44" * 32, None, 4096,
                      [(b"\x55" * 32, 10), (b"\x66" * 32, 20)], now=95.0)
    s.add_event(pkg.EVENT_BACKUP, {"size": 4096}, now=99.0)
    return peers


def _read(s, peers):
    return {
        "secret": s.get_root_secret(),
        "key": s.get_obfuscation_key(),
        "path": s.get_backup_path(),
        "index": s.get_highest_sent_index(),
        "cursor": s.get_audit_cursor(b"\x22" * 13),
        "peers": [tuple(vars(p).values()) for p in s.list_peers()],
        "placements": [s.shard_placements_for_peer(p) for p in peers],
        "stripe": sorted(s.shards_for_packfile(b"\x22" * 12)),
        "all": sorted(s.all_placements()),
        "audit": [tuple(vars(s.get_audit_state(p)).values()) for p in peers],
        "demoted": s.demoted_peers(),
        "storage": [p.pubkey for p in s.find_peers_with_storage()],
        "due": s.audit_due_peers(now=100.0),
        "stats": [tuple(vars(r).values()) for r in s.all_peer_stats()],
        "snapshots": [tuple(vars(r).values()) for r in s.list_snapshots()],
        "live": s.live_blobs(),
        "last_backup": (s.last_event_time("backup"), s.last_backup_size()),
    }


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_each_package_opens_the_others_store(tmp_path, writer):
    w_pkg = PACKAGES[writer]
    r_pkg = PACKAGES["ref" if writer == "port" else "port"]
    s = w_pkg.Store(tmp_path / "cfg", data_base=tmp_path / "data")
    peers = _fill(w_pkg, s)
    want = _read(s, peers)
    s.close()
    s2 = r_pkg.Store(tmp_path / "cfg", data_base=tmp_path / "data")
    try:
        assert _read(s2, peers) == want
        assert peers[1] in want["demoted"]
        assert peers[1] not in want["storage"]
        # the reader goes on writing, and the writer reads that back
        s2.record_placement(b"\x77" * 12, peers[3], 5, now=200.0,
                            shard_index=4)
        assert s2.received_dir(peers[0]) == \
            tmp_path / "data" / "received_packfiles" / peers[0].hex()
    finally:
        s2.close()
    s3 = w_pkg.Store(tmp_path / "cfg", data_base=tmp_path / "data")
    try:
        assert (b"\x77" * 12, 5, 4) in s3.shard_placements_for_peer(peers[3])
    finally:
        s3.close()
