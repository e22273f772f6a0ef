"""The port's client side of the network plane vs the JAX package's.

The reference's cases of ``tests/test_p2p.py``, ``tests/test_control_plane.py``,
``tests/test_resume.py`` and ``tests/test_peer_stats.py`` run in pairs of
packages (see ``tests/test_torch_net_server.py`` for how a reference
case is re-created over another package): port against port, reference
against reference, and, for every case that starts a coordination server,
the port's ``ServerClient`` / ``P2PNode`` against the reference's
``CoordinationServer`` and the reference's clients against the port's
server.  On top of those, at tolerance 0: nodes of the two packages
transferring to each other store the same bytes on disk as nodes of one
package, ``validate_resume_offer`` returns the same verdicts, and a port
holder's ``serve_audit`` on ``GpuBackend(device="cpu")`` answers a
reference verifier over the wire with the proofs of the reference prover.

Every network case binds port 0 and runs under ``asyncio.wait_for``
(``BoundedLoop``, or its own ``wait_for``).
"""

import asyncio

import pytest

import test_control_plane as ref_control_plane
import test_p2p as ref_p2p
import test_peer_stats as ref_peer_stats
import test_resume as ref_resume
from backuwup_tpu import wire as ref_wire
from backuwup_tpu.audit import build_challenge_table as ref_build_table
from backuwup_tpu.audit import check_proofs as ref_check_proofs
from backuwup_tpu.audit import compute_proofs as ref_compute_proofs
from backuwup_tpu.audit import select_challenges as ref_select_challenges
from backuwup_tpu.crypto import KeyManager as RefKeyManager
from backuwup_tpu.net import client as ref_client
from backuwup_tpu.net import p2p as ref_p2p_mod
from backuwup_tpu.net import server as ref_server
from backuwup_tpu.ops.backend import CpuBackend as RefCpuBackend
from backuwup_tpu.ops.blake3_cpu import blake3_many as ref_blake3_many
from backuwup_tpu.snapshot.blob_index import ChallengeTable as RefChallengeTable
from backuwup_tpu.store import Store as RefStore
from backuwup_tpu_torch import wire
from backuwup_tpu_torch.crypto import KeyManager
from backuwup_tpu_torch.net import client, p2p, server
from backuwup_tpu_torch.ops.backend import GpuBackend
from backuwup_tpu_torch.store import Store
from test_torch_net_server import (NET_TIMEOUT_S, NOT_PORTED, PORT, REF,
                                   BoundedLoop, cases, rebind, run_case,
                                   uses_any)
from test_torch_net_server import _isolate  # noqa: F401  (autouse)

# the modules of the server side; a client is everything else
SERVER_SIDE = ("net.server", "net.serverstore", "net.matchmaking",
               "net.ring")


def _pair(client_pkg, server_pkg):
    def pick(path):
        if path.split(".")[0] in NOT_PORTED:
            return REF
        return server_pkg if path in SERVER_SIDE else client_pkg
    return pick


PAIRS = {"port": _pair(PORT, PORT), "ref": _pair(REF, REF),
         "port-client-ref-server": _pair(PORT, REF),
         "ref-client-port-server": _pair(REF, PORT)}
MODULES = (ref_p2p, ref_control_plane, ref_resume, ref_peer_stats)
NS = {pair: {mod: rebind(mod, pick) for mod in MODULES}
      for pair, pick in PAIRS.items()}


def _params(module):
    """Each case of ``module`` in the pairs that tell something apart:
    all four when it starts a coordination server, else port and ref."""
    out = []
    for case in cases(module):
        name, params = case.values
        mixed = uses_any(module, name, ("CoordinationServer",))
        for pair in PAIRS if mixed else ("port", "ref"):
            out.append(pytest.param(name, params, pair,
                                    id=f"{pair}-{case.id}"))
    return out


@pytest.fixture
def loop():
    lp = BoundedLoop()
    yield lp
    lp.close()


def _run(module, name, params, pair, request):
    ns = NS[pair][module]
    run_case(module, ns, name, params, request, {
        # test_peer_stats.py's plane, in the package under test
        "plane": lambda: ns["faults"].install(ns["faults"].FaultPlane(
            seed=77))})


@pytest.mark.parametrize("name,params,pair", _params(ref_p2p))
def test_p2p_cases(name, params, pair, request):
    _run(ref_p2p, name, params, pair, request)


@pytest.mark.parametrize("name,params,pair", _params(ref_control_plane))
def test_control_plane_cases(name, params, pair, request):
    _run(ref_control_plane, name, params, pair, request)


@pytest.mark.parametrize("name,params,pair", _params(ref_resume))
def test_resume_cases(name, params, pair, request):
    _run(ref_resume, name, params, pair, request)


@pytest.mark.parametrize("name,params,pair", _params(ref_peer_stats))
def test_peer_stats_cases(name, params, pair, request):
    _run(ref_peer_stats, name, params, pair, request)


def test_cases_were_found():
    """The counts the issue names: 4, 8, 21 and 7 cases; the mixed pairs
    resolve the client and the server from different packages."""
    assert [len(cases(m)) for m in MODULES] == [4, 8, 21, 7]
    ns = NS["port-client-ref-server"][ref_p2p]
    assert ns["ServerClient"] is client.ServerClient
    assert ns["P2PNode"] is p2p.P2PNode
    assert ns["CoordinationServer"] is ref_server.CoordinationServer
    ns = NS["ref-client-port-server"][ref_p2p]
    assert ns["ServerClient"] is ref_client.ServerClient
    assert ns["CoordinationServer"] is server.CoordinationServer


# --- nodes of the two packages talk to each other ------------------------------


PKGS = {
    PORT: dict(KeyManager=KeyManager, Store=Store, client=client, p2p=p2p,
               wire=wire),
    REF: dict(KeyManager=RefKeyManager, Store=RefStore, client=ref_client,
              p2p=ref_p2p_mod, wire=ref_wire),
}


async def _node(pkg, root, name, port, secret):
    """One client of package ``pkg``: registered, logged in, on the push
    channel, with a fixed obfuscation key."""
    m = PKGS[pkg]
    keys = m["KeyManager"].from_secret(secret)
    store = m["Store"](root / name / "cfg", data_base=root / name / "data")
    store.set_obfuscation_key(b"\x5a\x01\xc3\x7e")
    c = m["client"].ServerClient(keys, store, addr=f"127.0.0.1:{port}",
                                 tls=False)
    await c.register()
    await c.login()
    node = m["p2p"].P2PNode(keys, store, c)
    c.start_ws()
    await asyncio.wait_for(c.ws_connected.wait(), 10)
    return keys, store, c, node


def _files(seed):
    import random

    rnd = random.Random(seed)
    k = wire.FileInfoKind
    return [(k.PACKFILE, bytes([1]) * 12, rnd.randbytes(70_000)),
            (k.SHARD, bytes([2]) * 12 + b"\x03", rnd.randbytes(40_000)),
            (k.INDEX, (0).to_bytes(8, "little"), rnd.randbytes(9_000)),
            # over TRANSFER_CHUNK_BYTES: FILE_PART frames, resume query
            (k.PACKFILE, bytes([4]) * 12, rnd.randbytes((1 << 20) + 4321))]


async def _exchange(root, server_pkg, sender_pkg, holder_pkg):
    """``sender_pkg``'s node ships :func:`_files` to ``holder_pkg``'s
    node over a server of ``server_pkg``, then pulls them back over
    ``RESTORE_FETCH``; returns the holder's stored tree and what came
    back."""
    srv = (server if server_pkg == PORT else ref_server).CoordinationServer()
    port = await srv.start()
    try:
        ka, sa, ca, na = await _node(sender_pkg, root, "a", port, b"\x01" * 32)
        kb, sb, cb, nb = await _node(holder_pkg, root, "b", port, b"\x02" * 32)
        sa.add_peer_negotiated(kb.client_id, 1 << 30)
        sb.add_peer_negotiated(ka.client_id, 1 << 30)
        hp = PKGS[holder_pkg]["p2p"]
        done = asyncio.Event()

        async def accept(source, transport):
            w = hp.ReceivedFilesWriter(sb, source)
            await hp.Receiver(transport, w.sink, part_sink=w.sink_part,
                              resume_query=w.resume_offer).run()
            done.set()

        nb.on_transport_request = accept
        nb.on_restore_fetch_request = nb.serve_restore_fetch
        sw = PKGS[sender_pkg]["wire"]
        t = await na.connect(kb.client_id, sw.RequestType.TRANSPORT)
        for kind, fid, data in _files(7):
            await t.send_file(data, sw.FileInfoKind(kind), fid)
        await t.close()
        await asyncio.wait_for(done.wait(), 20)
        stored = {str(p.relative_to(sb.received_dir(ka.client_id))):
                  p.read_bytes()
                  for p in sb.received_dir(ka.client_id).rglob("*")
                  if p.is_file()}
        sp = PKGS[sender_pkg]["p2p"]
        back = sp.RestoreFilesWriter(sa, base=root / "back")
        t = await na.connect(kb.client_id, sw.RequestType.RESTORE_FETCH)
        await na.request_fetch(t, [(sw.FileInfoKind(k), f)
                                   for k, f, _d in _files(7)])
        n = await sp.Receiver(t, back.sink, part_sink=back.sink_part,
                              resume_query=back.resume_offer).run()
        await t.close()
        pulled = {str(p.relative_to(root / "back")): p.read_bytes()
                  for p in (root / "back").rglob("*") if p.is_file()}
        await ca.close()
        await cb.close()
        sa.close()
        sb.close()
        return stored, pulled, n
    finally:
        await srv.stop()


@pytest.mark.parametrize("server_pkg", [PORT, REF], ids=["port-server",
                                                         "ref-server"])
@pytest.mark.parametrize("sender_pkg,holder_pkg", [(PORT, REF), (REF, PORT)],
                         ids=["port-to-ref", "ref-to-port"])
def test_mixed_nodes_store_and_return_the_same_bytes(
        server_pkg, sender_pkg, holder_pkg, tmp_path, loop):
    """A transfer between nodes of the two packages stores, byte for
    byte, what a transfer between reference nodes stores, and the
    ``RESTORE_FETCH`` pull gives back the sent files."""
    mixed = loop.run_until_complete(
        _exchange(tmp_path / "mixed", server_pkg, sender_pkg, holder_pkg))
    ref = loop.run_until_complete(
        _exchange(tmp_path / "ref", REF, REF, REF))
    assert mixed == ref
    stored, pulled, n = mixed
    assert n == len(_files(7)) == 4
    assert len(stored) == 4 and not any("partial" in p and stored[p]
                                        for p in stored)
    want = {data for _k, _f, data in _files(7)}
    assert set(pulled.values()) == want


def test_validate_resume_offer_verdicts_equal():
    """The sender's resume decision, for every kind of offer a receiver
    can make: the same (start, outcome) in both packages, and the same
    refusals."""
    import random

    rnd = random.Random(3)
    data = rnd.randbytes(3 * (1 << 20) + 17)
    fid = b"\x07" * 12
    digest = ref_blake3_many([data])[0]

    def offer(mod, offset, file_digest, prefix, kind=None, file_id=fid):
        return mod.P2PBody(
            kind=kind or mod.P2PBodyKind.RESUME_OFFER,
            header=mod.P2PHeader(sequence_number=1,
                                 session_nonce=b"\x00" * 16),
            file_id=file_id, offset=offset, file_digest=file_digest,
            prefix_digest=prefix)

    offers = [(0, digest, b""), (-5, digest, b""), (len(data) + 1, digest,
                                                    b""),
              (1 << 20, b"\x01" * 32, ref_blake3_many([data[:1 << 20]])[0]),
              (1 << 20, digest, b"\x02" * 32)]
    offers += [(off, digest, ref_blake3_many([data[:off]])[0])
               for off in (1, 1 << 20, 2 * (1 << 20) + 5, len(data))]
    for off, dg, prefix in offers:
        got = p2p.validate_resume_offer(offer(wire, off, dg, prefix), data,
                                        digest, fid)
        want = ref_p2p_mod.validate_resume_offer(
            offer(ref_wire, off, dg, prefix), data, digest, fid)
        assert got == want, (off, got, want)
    outcomes = {p2p.validate_resume_offer(offer(wire, o, d, p), data,
                                          digest, fid)[1]
                for o, d, p in offers}
    assert outcomes == {"cold", "restarted_stale", "restarted_corrupt",
                        "resumed"}
    for bad in ({"kind": "FILE"}, {"file_id": b"\x08" * 12}):
        for mod, wmod in ((p2p, wire), (ref_p2p_mod, ref_wire)):
            kw = dict(bad)
            if "kind" in kw:
                kw["kind"] = wmod.P2PBodyKind.FILE
            with pytest.raises(mod.P2PError):
                mod.validate_resume_offer(
                    offer(wmod, 1, digest, b"", **kw), data, digest, fid)


def test_serve_audit_answers_a_reference_verifier(tmp_path, loop,
                                                  monkeypatch):
    """``Engine.audit_peer`` of the reference against a port holder: the
    holder's ``serve_audit`` on ``GpuBackend(device="cpu")`` answers the
    CHALLENGE with proofs equal to the reference prover's over the same
    stored bytes, the reference verifier passes them, and after one
    window rots on the holder's disk it catches exactly that window."""
    import random

    from backuwup_tpu_torch import defaults

    # the holder serves one audit per peer per interval; two rounds here
    monkeypatch.setattr(defaults, "AUDIT_SERVE_MIN_INTERVAL_S", 0.0)
    rnd = random.Random(11)
    packs = {bytes([i]) * 12: rnd.randbytes(50_000 + 9_000 * i)
             for i in range(1, 4)}

    async def run():
        srv = ref_server.CoordinationServer()
        port = await srv.start()
        try:
            ko, so, co, no = await _node(REF, tmp_path, "owner", port,
                                         b"\x03" * 32)
            kh, sh, ch, nh = await _node(PORT, tmp_path, "holder", port,
                                         b"\x04" * 32)
            so.add_peer_negotiated(kh.client_id, 1 << 30)
            sh.add_peer_negotiated(ko.client_id, 1 << 30)
            stored = asyncio.Event()

            async def accept(source, transport):
                w = p2p.ReceivedFilesWriter(sh, source)
                await p2p.Receiver(transport, w.sink).run()
                stored.set()

            async def audit(source, transport):
                await nh.serve_audit(source, transport,
                                     GpuBackend(device="cpu"))

            nh.on_transport_request = accept
            nh.on_audit_request = audit
            tables = RefChallengeTable(ko, so.challenge_dir())
            cpu = RefCpuBackend()
            t = await no.connect(kh.client_id, ref_wire.RequestType.TRANSPORT)
            for pid, data in packs.items():
                tables.save(pid, ref_build_table(cpu, data,
                                                 rand=rnd.randbytes))
                await t.send_data(data, ref_wire.FileInfoKind.PACKFILE, pid)
                so.record_placement(pid, kh.client_id, len(data))
            await t.close()
            await asyncio.wait_for(stored.wait(), 20)

            async def challenge(challenges):
                t = await no.connect(kh.client_id, ref_wire.RequestType.AUDIT)
                try:
                    seq = t.seq
                    t.seq += 1
                    await t.send_body(ref_wire.P2PBody(
                        kind=ref_wire.P2PBodyKind.CHALLENGE,
                        header=ref_wire.P2PHeader(
                            sequence_number=seq,
                            session_nonce=t.session_nonce),
                        challenges=tuple(challenges)))
                    reply = await t.recv_body(15.0)
                finally:
                    await t.close()
                assert reply.kind == ref_wire.P2PBodyKind.PROOF
                assert reply.header.sequence_number == seq
                return list(reply.proofs)

            # the reference prover over the holder's files, opened by the
            # reference's own store
            holder_as_ref = RefStore(tmp_path / "holder" / "cfg",
                                     data_base=tmp_path / "holder" / "data")
            try:
                challenges, expected = ref_select_challenges(
                    so, tables, kh.client_id)
                assert len(challenges) == 8
                proofs = await challenge(challenges)
                assert proofs == ref_compute_proofs(
                    holder_as_ref, cpu, ko.client_id, challenges)
                res = ref_check_proofs(challenges, expected, proofs)
                assert res.passed and res.checked == 8

                # one window of the next challenged packfile rots
                challenges, expected = ref_select_challenges(
                    so, tables, kh.client_id)
                c = challenges[0]
                pos = c.offset + c.length // 2
                path = sh.received_dir(ko.client_id) / "pack" / \
                    bytes(c.packfile_id).hex()
                raw = bytearray(path.read_bytes())
                raw[pos] ^= 0xFF
                path.write_bytes(bytes(raw))
                proofs = await challenge(challenges)
                assert proofs == ref_compute_proofs(
                    holder_as_ref, cpu, ko.client_id, challenges)
                res = ref_check_proofs(challenges, expected, proofs)
                assert not res.passed and "digest mismatch" in res.detail
                # exactly the windows over the rotten byte fail
                assert [p.digest != e for p, e in zip(proofs, expected)] == [
                    d.packfile_id == c.packfile_id
                    and d.offset <= pos < d.offset + d.length
                    for d in challenges]
            finally:
                holder_as_ref.close()
            await co.close()
            await ch.close()
            so.close()
            sh.close()
        finally:
            await srv.stop()

    loop.run_until_complete(asyncio.wait_for(run(), NET_TIMEOUT_S))
