"""The port's engine GC and crash recovery vs the JAX package's.

The non-slow cases of ``tests/test_gc.py`` (retention, mark and sweep,
compaction, the placement swap and its crash seams, reclaim, the
recovery of a half-applied swap) and of ``tests/test_crash.py`` (the
crash-site registry, the injection plane, durable commits and
``Engine.recover``'s per-seam sweeps) run through both packages, port
against port and reference against reference, as
``tests/test_torch_engine.py`` runs the engine's other cases (see there
for how a case is re-created over a package).  They sit in a file of
their own so that the test workers spread the engine's cases over two
of them.
"""

import pytest

import test_crash as ref_crash
import test_gc as ref_gc
from test_torch_engine import ns_for, params_of, run_ref
from test_torch_net_server import _isolate  # noqa: F401  (autouse)

# left out, with the reason; the reference's own files still run them
SKIP_GC = (
    # lints the package with ``analysis`` (BKW003), not ported yet
    "test_crash_site_registry_is_exact_per_bkw003",
    # drives ``scenario.run_scenario``, not ported yet
    "test_gc_scenario_races_collection_against_backup_restore",
)
SKIP_CRASH = (
    # drives ``scenario.run_scenario``, not ported yet
    "test_crash_scenario_recovers_representative_seams",
)


@pytest.mark.parametrize("name,params,pair_name",
                         params_of(ref_gc, skip=SKIP_GC))
def test_gc_cases(name, params, pair_name, request):
    run_ref(ref_gc, ns_for(ref_gc, pair_name), name, params, request)


@pytest.mark.parametrize("name,params,pair_name",
                         params_of(ref_crash, skip=SKIP_CRASH))
def test_crash_cases(name, params, pair_name, request):
    run_ref(ref_crash, ns_for(ref_crash, pair_name), name, params, request)


def test_gc_and_crash_cases_were_found():
    """The left-out cases exist (a rename would otherwise run them), and
    the port's namespaces build the port's engine."""
    from backuwup_tpu_torch import engine as port_engine
    from test_torch_engine import CpuEngine
    from test_torch_net_server import cases

    assert set(SKIP_GC) <= {c.values[0] for c in cases(ref_gc)}
    assert set(SKIP_CRASH) <= {c.values[0] for c in cases(ref_crash)}
    assert ns_for(ref_gc, "port")["Engine"] is CpuEngine
    assert issubclass(CpuEngine, port_engine.Engine)
    assert ns_for(ref_crash, "port")["faults"].__name__ == \
        "backuwup_tpu_torch.utils.faults"
