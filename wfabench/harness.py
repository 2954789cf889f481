"""One run of one cell: set-up, the measured window, the drain, the
comparison with the reference and the metrics, as the result's dict.

`run_cell` takes the device as an argument: `run.py` hands it the card
after checking that one is there, and the tests drive it on the CPU with
the program's plain versions of its kernels.
"""
from __future__ import annotations

import gc
from types import SimpleNamespace

import numpy as np

from wfabench import check, manifest, program, roofline, tracing


def _peak_bytes(device):
    """torch.cuda.max_memory_allocated() on the card; None off it."""
    import torch
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated()


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             t_proc: float) -> dict:
    """Run `cell` once; returns the result line's dict and, under
    "counters", what the program counted in the window."""
    import torch
    cuda = torch.device(device).type == "cuda"
    config, traffic = cell["config"], cell["traffic"]
    rng = np.random.default_rng(seed % 2**64)
    spans = None
    if trace:
        program.prof_enable()
        spans = tracing.Spans().install()
    driver = manifest.load_driver(traffic["driver"], cell["bench_dir"])
    run = driver.Run(cell, rng, device)
    run.warm_up()
    if cuda:
        torch.cuda.synchronize()
    setup_peak = _peak_bytes(device)
    # what set-up left alive (the pool above all) is not scanned again by
    # the collector inside the window
    gc.collect()
    gc.freeze()

    def on_start():
        program.reset_counters()
        if spans is not None:
            spans.reset()
            program.prof_reset()
        if cuda:
            torch.cuda.reset_peak_memory_stats()

    win = run.window(seconds, on_start)
    window_peak = _peak_bytes(device)
    prof = program.prof_read() if trace else {}
    span_total = dict(spans.total) if spans else {}
    counters = program.read_counters()
    tracer, slice_pairs = None, []
    if trace:
        # the profiled slice follows the window, so that the profiler's
        # start and stop stay out of the window's spans
        tracer = tracing.Slice()
        slice_pairs = run.traced_slice(tracer)
    run.drain()
    if spans is not None:
        spans.uninstall()
    setup_s = win["t_start"] - t_proc

    # the program's state goes before the reference runs on the card
    answers = run.answers(win.pop("kept"))
    pats, txts = run.pairs()
    run.close()
    del run
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    pen = config["penalties"]
    full = traffic["scope"] == "full"
    cost_of = check.reference_costs(
        pats, txts, [j for j, _ in answers] + slice_pairs, pen, device)
    numbers = check.judge(pats, txts, answers, cost_of, pen, full)
    correct = check.verdict(numbers)

    sl = tracer.read() if tracer is not None else None
    roof = None
    if slice_pairs and sl and sl.get("fused_loop_s"):
        # the work of the pairs dispatched in the slice, from the scores
        # the check confirmed, over the fused loop's device time there
        n_ops, n_bytes = roofline.work(
            pen["mismatch"], pen["gap_opening"], pen["gap_extension"],
            config["components"], full, [cost_of[j] for j in slice_pairs],
            [len(pats[j]) for j in slice_pairs],
            [len(txts[j]) for j in slice_pairs])
        pct, bound = roofline.share(n_ops, n_bytes, sl["fused_loop_s"])
        roof = {"operations": n_ops, "bytes": n_bytes, "bound": bound,
                "fused_loop_s": sl["fused_loop_s"], "percent": pct}
    ctx = SimpleNamespace(config=config, traffic=traffic, window=win,
                          setup_s=setup_s, window_peak_bytes=window_peak,
                          prof=prof, spans=span_total, slice=sl,
                          roofline=roof)
    wanted = cell["per_layer"] if trace else cell["end_to_end"]
    metrics = {}
    for m in wanted:
        value = manifest.load_reader(m["name"], cell["bench_dir"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name() if cuda
                            else "cpu"),
                   "count": cell["chips"],
                   "memory_peak_bytes": max(setup_peak or 0,
                                            window_peak or 0)}
    result = {"correct": correct, "attempted": win["pairs"],
              "failed": numbers["wrong_answers"],
              "metrics": metrics, "device": device_info}
    if trace and sl and sl.get("device_events"):
        device_info["busy_s"] = sl["busy_s"]
        device_info["window_s"] = sl["wall_s"]
        result["breakdown"] = {"device_ops": [list(p) for p in
                                              sl["device_ops"]],
                               "idle_gaps": [list(p) for p in
                                             sl["idle_gaps"]]}
    compared = {k: {"value": numbers[k], "limit": lim}
                for k, lim in check.LIMITS.items()}
    compared["judged"] = {"value": numbers["judged"], "at_least": 1}
    result["compared"] = compared
    return {"result": result, "counters": counters, "roofline": roof,
            "judged": {k: numbers[k] for k in check.KINDS},
            "window_s": win["t_end"] - win["t_start"],
            "slice": {k: v for k, v in (sl or {}).items()
                      if k not in ("device_ops", "idle_gaps")}}
