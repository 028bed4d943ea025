"""``chip_smoke.py``'s ``phase_operate`` at its small size on the CPU
(``tiny``): every gate it holds on the card but the launch counts, the
kernels in the traces and the device's memory, and the teardown check
that ``main()`` runs before its last lines, so that a server or watchdog
thread left behind fails here before it reaches the card."""
import importlib
import sys
import threading
from pathlib import Path


def _chip_smoke():
    repo = str(Path(__file__).resolve().parents[1])
    if repo not in sys.path:
        sys.path.insert(0, repo)
    return importlib.import_module("chip_smoke")


def test_phase_operate_rehearses_on_the_cpu():
    cs = _chip_smoke()
    before = set(threading.enumerate())
    out = cs.phase_operate("cpu", device="cpu", small=True)
    checks = out["checks"]
    for name in ("losses_bitwise", "metrics_200", "healthz_200",
                 "healthz_held_503", "healthz_after_200", "records",
                 "tensorboard_losses", "traces", "flops_within",
                 "cost_complete", "serving_counters_equal",
                 "serving_trace_json", "serving_outputs_finite"):
        assert checks[name] is True, (name, checks)
    assert out["flops_rel_err"] <= cs.OPERATE_FLOP_REL
    assert sorted(out["traces"]) == ["trace_step0.json", "trace_step4.json"]
    assert out["serving"]["engine_requests"] == cs.OPERATE["requests"]
    # main()'s teardown check: nothing the phase started is left
    assert checks["threads_left"] == []
    assert not [item for item in cs.leftovers()
                if "torch.distributed" in item]
    assert not any(t.name.startswith(cs._STOPPED_THREADS)
                   for t in set(threading.enumerate()) - before)


def test_teardown_check_names_what_is_left():
    """A server thread still running when ``main()`` would print its last
    lines is listed (and would fail the script)."""
    cs = _chip_smoke()
    from bigdl_tpu_torch.observability import IntrospectionServer, Recorder
    srv = IntrospectionServer(Recorder()).start()
    try:
        assert f"thread introspection:{srv.port}" in cs.leftovers()
    finally:
        srv.stop()
    assert f"thread introspection:{srv.port}" not in cs.leftovers()
