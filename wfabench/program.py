"""What the harness touches of the program under test, `pywfa_tpu_torch`:
the aligners' arguments, and the counters that say which path a run took.
Nothing here imports the program at import time."""
from __future__ import annotations


def aligner_kwargs(config: dict, traffic: dict) -> dict:
    """pywfa's keyword arguments for the configuration's penalties and
    memory mode and the traffic's scope and span."""
    pen = config["penalties"]
    kw = dict(distance=pen["distance"], mismatch=pen["mismatch"],
              gap_opening=pen["gap_opening"],
              gap_extension=pen["gap_extension"],
              memory_mode=config["memory_mode"], scope=traffic["scope"],
              span=traffic["span"])
    return kw


def _counter_dicts():
    from pywfa_tpu_torch import batch
    from pywfa_tpu_torch.ops import fused_loop
    return {"oracle_fallbacks": batch.oracle_fallbacks,
            "segmented_runs": batch.segmented_runs,
            "build_launches": fused_loop.build_launches,
            "group_launches": fused_loop.group_launches}


def reset_counters():
    for counts in _counter_dicts().values():
        for k in counts:
            counts[k] = 0


def read_counters() -> dict:
    return {name: {str(k): v for k, v in counts.items() if v}
            for name, counts in _counter_dicts().items()}


def prof_enable():
    """Turn on the program's PYWFA_PROF stage timers (read from the
    environment when pywfa_tpu_torch.batch is imported; run.py sets it
    before that import)."""
    from pywfa_tpu_torch import batch
    batch._PROF = True


def prof_reset():
    from pywfa_tpu_torch import batch
    batch.PROF.clear()
    batch.PROF_N.clear()


def prof_read() -> dict:
    """Seconds by PYWFA_PROF key since prof_reset()."""
    from pywfa_tpu_torch import batch
    return dict(batch.PROF)
