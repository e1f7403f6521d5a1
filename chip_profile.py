"""Where the time goes: the port's serving main path under torch.profiler.

    python3 chip_profile.py [--src=DIR] [--out=NAME] [--pairs=N] [CELL ...]

Builds the kernels and serves, in the configurations of chip_smoke.py, the
cells named (all of them by default): `all-full` (phase 3: full-width
qwen2-1.5b, float32, 28 full-attention layers, chunked paged prefill, the
shared-prefix workload), `default-pattern` (phase 5: the default OmniAttn
pattern, whole-prompt prefill, the long-prompt workload) in both KV
layouts, `topk` (phase 6: 28 full layers, six 3,968-token prompts) with
online top-k off and at topk_frac 0.25 — `paged_decode` per call over the
full 256-wide table against the compacted one, `block_topk` (scores,
ranking and compaction in one launch) per call, and the aten ops one
decode step dispatches in each — `all-full-quant` (phase 9
(a): phase 3's server on int8 arenas, QuantPlane, phase 3's traffic with 24
new tokens and a sampled request; the same server on float32 arenas first,
on the same traffic), and `moe-full` (phase 8:
full-width qwen2-moe-a2.7b, float32, the shared-prefix workload with 16 new
tokens each, OmniPlacement's monitor every 4 decode rounds).
Each runs its workload four times: a warm-up, a measured run without the
profiler (TTFT, TPOT, tokens/s, per-engine host time), a run under
torch.profiler (device time by kernel, device busy and idle share), and a
run that counts the aten ops each decode step dispatches from Python (a
TorchDispatchMode around `DecodeEngine.step`: near zero on a step that
replays its captured graph). Each cell also reports the hot-loop entries'
keys, eager calls, captures and replays (`DevicePlacement.hot_loops`).
`--src=DIR` imports the port from another tree's `src` (a parent commit's,
unpacked with `git archive`), so two trees are compared by this one script
in one call; `--out=NAME` names the JSON file under chiprun_out/
(chip_profile.json by default). `--pairs=N` replaces the `topk` cell's
runs by capture against eager in turns (`capture_pairs`): N pairs of
measured runs on fresh servers, then a torch.profiler session and one
more pair, each run with the prefill chunks' device backlog split out.
Needs one CUDA device; prints the breakdown and writes the JSON.
"""
from __future__ import annotations

import gc
import json
import statistics
import sys
import time
from collections import Counter, defaultdict
from pathlib import Path

import torch

import chip_smoke as cs

CELLS = ("all-full", "default-pattern", "default-pattern-chunked", "topk",
         "all-full-quant", "moe-full")
KERNELS = ("paged_decode", "paged_prefill", "block_topk", "spec_verify",
           "flash_prefill", "sink_decode", "moe_gmm")
CATEGORIES = (("moe_gmm", ("moe_gmm_kernel",)),
              ("paged_prefill", ("paged_prefill_kernel",
                                 "paged_prefill_combine")),
              ("paged_decode", ("paged_decode_kernel",
                                "paged_decode_combine")),
              ("block_topk", ("block_topk_kernel",)),
              ("spec_verify", ("spec_verify_kernel", "spec_verify_combine")),
              ("flash_prefill", ("flash_prefill_kernel",)),
              ("sink_decode", ("sink_decode_kernel",
                               "sink_decode_combine")),
              ("gemm", ("gemm", "gemv", "sm90_xmma", "cutlass", "cublas")),
              ("index (gather/scatter)", ("index", "gather", "scatter")),
              ("reduce/softmax/sort", ("reduce", "softmax", "sort", "scan",
                                      "argmax", "max_", "min_")),
              ("copy/fill", ("memcpy", "memset", "copy", "fill")),
              ("elementwise", ("elementwise", "vectorized")))


# a kernel's calls are counted on its first name; the others (the split
# merges of paged_decode, paged_prefill, spec_verify and sink_decode) add
# device time to the same call
CALL_NAME = {cat: keys[0] for cat, keys in CATEGORIES}


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def dev_time(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def device_events(prof) -> dict:
    """{kernel name: [device µs, calls]} of a torch.profiler session,
    device-side events only (a CPU op's own device time would count its
    kernels twice)."""
    by_name = defaultdict(lambda: [0.0, 0])
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        t = dev_time(evt)
        if t > 0:
            by_name[evt.key][0] += t
            by_name[evt.key][1] += evt.count
    return by_name


def _op_counter():
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n[str(func.overloadpacket)] += 1
            return func(*args, **(kwargs or {}))
    return Count()


def count_step_ops(srv, workload) -> dict:
    """aten ops each decode step of `srv`'s first decode engine dispatches
    while it serves workload(10), counted with a TorchDispatchMode around
    `DecodeEngine.step` (the table upload, the fetch and anything a step
    runs eagerly; a graph replay dispatches none) → {"steps", "mean",
    "median", "min", "max", "by_op" (summed over the steps)}."""
    eng = srv.decodes[0]
    step, per_step, by_op = eng.step, [], Counter()

    def counted():
        n0 = eng.stats["steps"]
        mode = _op_counter()
        with mode:
            out = step()
        if eng.stats["steps"] > n0:
            per_step.append(sum(mode.n.values()))
            by_op.update(mode.n)
        return out
    eng.step = counted
    try:
        list(srv.generate(*workload(10)))
        torch.cuda.synchronize()
    finally:
        del eng.step
    return {"steps": len(per_step), "mean": statistics.fmean(per_step),
            "median": statistics.median(per_step), "min": min(per_step),
            "max": max(per_step),
            "by_op": dict(by_op.most_common(12))}


def capture_pairs(build, workload, label, n) -> list:
    """Capture against eager in turns: n pairs of measured runs (eager
    first in even pairs), each on a fresh server `build(placement)` warmed
    on workload(8) and measured on workload(7), then a torch.profiler
    session over one warmed capture run (its wall, device busy and idle
    share) and one more pair. Each run reports its wall, the host seconds
    in prefill and decode rounds and per chunk, the process time, and the
    prefill chunks' device backlog: what a torch.cuda.synchronize() at
    each chunk's start waits. An eager chunk's token upload from pageable
    memory waits for the same, so there the split adds no wait; a captured
    chunk uploads from pinned staging without waiting, and the sync moves
    its round's wait for the device from the first-token fetch to the
    chunks' starts."""
    from repro_torch.serving import DevicePlacement
    from repro_torch.serving.prefill import PrefillEngine
    run_chunk, acc = PrefillEngine._run_chunk, {"backlog_s": 0.0}

    def timed(self, task, budget):
        t0 = time.monotonic()
        torch.cuda.synchronize()
        acc["backlog_s"] += time.monotonic() - t0
        return run_chunk(self, task, budget)

    def one(capture, tag):
        srv = build(DevicePlacement.of(torch.device("cuda"), capture=capture))
        list(srv.generate(*workload(8)))
        cs.reset_stats(srv)
        acc["backlog_s"] = 0.0
        c0 = time.process_time()
        _, _, summ, wall = cs.drive(srv, *workload(7))
        ps, ds = srv.prefills[0].stats, srv.decodes[0].stats
        r = {"run": tag, "capture": capture, "wall_s": wall,
             "prefill_host_s": ps["busy_s"], "chunks": ps["chunks"],
             "decode_host_s": ds["busy_s"], "steps": ds["steps"],
             "process_s": time.process_time() - c0,
             "backlog_s": acc["backlog_s"], "tpot_mean_ms":
             summ["tpot_mean_ms"], "ttft_mean": summ["ttft_mean"],
             "host_ms_per_chunk": ps["busy_s"] * 1e3 / max(ps["chunks"],
                                                            1)}
        print(f"{label}: {tag} {'capture' if capture else 'eager'}: wall "
              f"{wall:.3f} s, host in prefill / decode rounds "
              f"{r['prefill_host_s']:.3f} / {r['decode_host_s']:.3f} s "
              f"({r['chunks']} chunks, {r['steps']} steps), process time "
              f"{r['process_s']:.3f} s, prefill backlog "
              f"{r['backlog_s']:.3f} s, TPOT {r['tpot_mean_ms']:.1f} ms, "
              f"host {r['host_ms_per_chunk']:.2f} ms per chunk")
        del srv
        torch.cuda.empty_cache()
        return r

    PrefillEngine._run_chunk = timed
    try:
        runs = []
        for i in range(n):
            for cap in ((False, True) if i % 2 == 0 else (True, False)):
                runs.append(one(cap, f"pair {i}"))
        srv = build(DevicePlacement.of(torch.device("cuda")))
        list(srv.generate(*workload(8)))
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.monotonic()
            list(srv.generate(*workload(9)))
            torch.cuda.synchronize()
            pwall = time.monotonic() - t0
        busy = sum(t for t, _ in device_events(prof).values()) / 1e6
        runs.append({"run": "profiled, capture", "wall_s": pwall,
                     "device_busy_s": busy,
                     "device_idle_share": 1.0 - busy / pwall})
        print(f"{label}: profiled capture run: wall {pwall:.3f} s, device "
              f"busy {busy:.3f} s, idle share {1.0 - busy / pwall:.3f}")
        del srv
        for cap in (False, True):
            runs.append(one(cap, "after a profiler session"))
    finally:
        PrefillEngine._run_chunk = run_chunk
    return runs


def hot_loop_summary(srv):
    """The placement's hot-loop entries (None for a tree without them)."""
    reg = getattr(srv.placement, "hot_loops", None)
    if reg is None:
        return None
    out = reg.summary()
    for v in out.values():
        v["keys"] = [list(k) for k in v["keys"]]
    pool = getattr(srv.placement, "graph_pool_bytes", None)
    return {"entries": out, "pool_gb": pool() / 1e9 if pool else None}


def count_decode_ops(srv) -> dict:
    """aten ops one `LM.decode` step dispatches with this server's model,
    arena type (float or int8, QuantPlane) and top-k budget, six slots over
    fresh arenas and a 4-wide table (a top-k budget of 0.25 keeps 3 of its
    blocks, so selection runs): {"total": n, "by_op": {op: n}}. Counted
    with a TorchDispatchMode, so views are included; each op the step
    dispatches costs host time."""
    from repro_torch.models.stack import alloc_arena_kv

    lm, dev = srv.lm, srv.lm.device
    B, nb = 6, 4
    cache = {"layers": alloc_arena_kv(lm.cfg, lm.plan, B * nb + 1, 16, dev,
                                      quant=srv.kv_arena.quant), "pos": 0}
    tables = torch.arange(1, B * nb + 1, dtype=torch.int32,
                          device=dev).reshape(B, nb)
    tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    pos = torch.full((B, 1), 15, dtype=torch.int32, device=dev)
    mode = _op_counter()
    with mode:
        lm.decode(srv.params, cache, tok, pos, block_tables=tables)
    torch.cuda.synchronize()
    return {"total": sum(mode.n.values()), "by_op": dict(mode.n)}


def profile(srv, workload, smi: str, label: str) -> dict:
    """Warm-up, measured and profiled runs of one server on `workload(seed)`
    → (prompts, params); prints and returns the breakdown."""
    list(srv.generate(*workload(8)))                       # warm-up
    cs.reset_stats(srv)
    _, _, summ, wall = cs.drive(srv, *workload(7))
    ps, ds = dict(srv.prefills[0].stats), dict(srv.decodes[0].stats)
    rep = {"measured": {k: summ[k] for k in (
        "n_done", "ttft_mean", "ttft_p99", "tpot_mean_ms", "tpot_p99_ms",
        "ott_tok_s", "ttt_tok_s")} | {
        "wall_s": wall, "prefill_busy_s": ps["busy_s"],
        "decode_busy_s": ds["busy_s"], "chunks": ps["chunks"],
        "whole_prefills": ps["prefills"] if not srv.prefills[0].chunked
        else 0, "steps": ds["steps"], "prefill_tokens": ps["tokens"]}}

    cs.reset_stats(srv)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        list(srv.generate(*workload(9)))
        torch.cuda.synchronize()
        pwall = time.monotonic() - t0
    by_name = device_events(prof)
    busy_us = sum(t for t, _ in by_name.values())
    by_cat = defaultdict(float)
    for name, (t, _) in by_name.items():
        by_cat[category(name)] += t
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]
    per_call = {}
    for name, (t, c) in by_name.items():
        cat = category(name)
        if cat in KERNELS:
            tot = per_call.setdefault(cat, [0.0, 0])
            tot[0] += t
            tot[1] += c if CALL_NAME[cat] in name.lower() else 0
    rep["profiled"] = {
        "wall_s": pwall, "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / pwall,
        "by_category_s": {k: v / 1e6 for k, v in
                          sorted(by_cat.items(), key=lambda kv: -kv[1])},
        "top_ops": [{"name": n[:120], "device_s": t / 1e6, "count": c}
                    for n, (t, c) in top],
        "kernel_ms_per_call": {k: {"ms": t / 1e3 / max(c, 1), "calls": c}
                               for k, (t, c) in per_call.items()}}

    rep["step_ops"] = count_step_ops(srv, workload)
    if srv.prefills[0].chunked:
        rep["measured"]["host_ms_per_chunk"] = \
            ps["busy_s"] * 1e3 / max(ps["chunks"], 1)
        rep["chunk_ops"] = cs.count_chunk_ops(srv, *workload(11))
    rep["hot_loops"] = hot_loop_summary(srv)

    m, p = rep["measured"], rep["profiled"]
    print(f"{label}: measured run [{smi}]: wall {m['wall_s']:.3f} s, TTFT "
          f"mean {m['ttft_mean'] * 1e3:.1f} ms, TPOT mean "
          f"{m['tpot_mean_ms']:.1f} ms, {m['ttt_tok_s']:.0f} tok/s total; "
          f"host time in prefill rounds {m['prefill_busy_s']:.3f} s "
          f"({m['chunks']} chunks, {m['whole_prefills']} whole prompts), in "
          f"decode rounds {m['decode_busy_s']:.3f} s ({m['steps']} steps)")
    print(f"{label}: profiled run [{smi}]: wall {p['wall_s']:.3f} s, device "
          f"busy {p['device_busy_s']:.3f} s, idle share "
          f"{p['device_idle_share']:.3f}")
    so = rep["step_ops"]
    print(f"{label}: aten ops dispatched per decode step over "
          f"{so['steps']} steps: mean {so['mean']:.1f}, median "
          f"{so['median']}, min {so['min']}, max {so['max']}")
    if "chunk_ops" in rep:
        co = rep["chunk_ops"]
        print(f"{label}: host {m['host_ms_per_chunk']:.2f} ms per prefill "
              f"chunk (measured run); aten ops dispatched per chunk over "
              f"{co['chunks']} chunks: mean {co['mean']:.1f}, min "
              f"{co['min']}, max {co['max']}")
    hl = rep["hot_loops"]
    if hl is None:
        print(f"{label}: no hot-loop entries in this tree")
    else:
        for name, v in hl["entries"].items():
            print(f"{label}: hot loop {name}: {len(v['keys'])} keys, "
                  f"{v['eager']} eager calls, {v['captures']} captures, "
                  f"{v['replays']} replays (all four runs)")
        print(f"{label}: graph pool {hl['pool_gb']:.3f} GB")
    for cat, t in p["by_category_s"].items():
        print(f"  {cat:24s} {t * 1e3:9.2f} ms")
    for k, v in p["kernel_ms_per_call"].items():
        print(f"  {k}: {v['ms']:.4f} ms per call x {v['calls']}")
    for op in p["top_ops"]:
        print(f"  {op['device_s'] * 1e3:9.2f} ms x{op['count']:5d}  "
              f"{op['name'][:90]}")
    return rep


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    src, out_name, pairs = cs.ROOT / "src", "chip_profile.json", 0
    for a in [a for a in args if a.startswith("--")]:
        key, _, val = a.partition("=")
        if key == "--src":
            src = Path(val).resolve()
        elif key == "--out":
            out_name = val
        elif key == "--pairs":
            pairs = int(val)
        else:
            print(f"chip_profile: unknown option {a}", file=sys.stderr)
            return 2
    sys.path.insert(0, str(src))
    from repro_torch.core.proxy import SamplingParams
    from repro_torch.device import set_precision_policy
    from repro_torch.kernels import build
    set_precision_policy()
    dev = torch.device("cuda")
    smi = cs.nvidia_smi()
    build.build_all()
    cfg = cs.full_width_config()
    rep = {"gpu": smi, "torch": torch.__version__, "src": str(src)}
    print(f"chip_profile: the port from {src} [{smi}]")
    cells = [a for a in args if not a.startswith("--")] or list(CELLS)
    unknown = set(cells) - set(CELLS)
    if unknown:
        print(f"chip_profile: unknown cells {sorted(unknown)}; known: "
              f"{CELLS}", file=sys.stderr)
        return 2

    weights = None
    if "all-full" in cells:
        def shared_prefix(seed):
            prompts, _ = cs.workload(cfg.vocab_size, seed=seed)
            return prompts, [SamplingParams(max_tokens=4)] * len(prompts)

        srv = cs.build_server(cfg, True, dev)
        weights = srv.params
        if pairs:
            del srv
            rep["all_full_pairs"] = capture_pairs(
                lambda pl: cs.build_server(cfg, True, dev, params=weights,
                                           placement=pl),
                shared_prefix, f"all-full [{smi}]", pairs)
            srv = cs.build_server(cfg, True, dev, params=weights)
        rep.update(profile(srv, shared_prefix, smi,
                           "all-full, chunked paged"))
        del srv
        torch.cuda.empty_cache()

    if "default-pattern" in cells:
        def long_prompts(seed):
            return cs.default_pattern_workload(cfg.vocab_size,
                                               seed=20 + seed)

        rep["default_pattern"] = {}
        for paged in (True, False):
            name = "paged" if paged else "dense"
            srv = cs.build_default_server(cfg, paged, dev, params=weights)
            weights = srv.params
            rep["default_pattern"][name] = profile(
                srv, long_prompts, smi, f"pattern=None, {name} KV")
            del srv
            torch.cuda.empty_cache()

    if "default-pattern-chunked" in cells:
        def long_prompts(seed):
            return cs.default_pattern_workload(cfg.vocab_size,
                                               seed=20 + seed)

        rep["default_pattern_chunked"] = {}
        for paged in (True, False):
            name = "paged" if paged else "dense"
            try:
                srv = cs.build_ring_chunk_server(cfg, paged, True, dev,
                                                 params=weights)
            except NotImplementedError as e:      # a tree without A20
                print(f"pattern=None chunked, {name} KV: not served by "
                      f"this tree ({e})")
                rep["default_pattern_chunked"][name] = None
                continue
            weights = srv.params
            rep["default_pattern_chunked"][name] = profile(
                srv, long_prompts, smi,
                f"pattern=None, prefill_sparse, chunked, {name} KV")
            del srv
            torch.cuda.empty_cache()

    if "topk" in cells:
        def topk_prompts(seed):
            return cs.topk_workload(cfg.vocab_size, seed=30 + seed)

        rep["topk"] = {}
        for name, topk in (("off", {}), ("frac_0.25", dict(
                omniattn_topk_frac=0.25, omniattn_topk_sink_blocks=1,
                omniattn_topk_recent_blocks=2))):
            srv = cs.build_topk_server(cfg, dev, params=weights, **topk)
            weights = srv.params
            if pairs:
                del srv
                rep["topk"][name] = {"pairs": capture_pairs(
                    lambda pl: cs.build_topk_server(
                        cfg, dev, params=weights, placement=pl, **topk),
                    topk_prompts, f"online top-k {name} [{smi}]", pairs)}
                continue
            rep["topk"][name] = profile(srv, topk_prompts, smi,
                                        f"online top-k {name}, 28 full "
                                        f"layers")
            ops = count_decode_ops(srv)
            rep["topk"][name]["decode_step_aten_ops"] = ops
            print(f"  one decode step ({cfg.n_layers} layers, 6 slots) "
                  f"dispatches {ops['total']} aten ops")
            del srv
            torch.cuda.empty_cache()

    if "all-full-quant" in cells:
        from repro_torch.serving.quant import QuantConfig

        def quant_traffic(seed):
            return cs.quant_workload(cfg.vocab_size, seed=seed)

        # the float32 arenas on the same traffic first: what the int8
        # writes add to a decode round shows against them, in one call
        rep["all_full_quant"] = {}
        for name, quant in (("float32", None), ("int8", QuantConfig())):
            srv = cs.build_server(cfg, True, dev, params=weights, quant=quant)
            weights = srv.params
            rep["all_full_quant"][name] = profile(
                srv, quant_traffic, smi,
                f"all-full-quant traffic, {name} arenas")
            ops = count_decode_ops(srv)
            rep["all_full_quant"][name]["decode_step_aten_ops"] = ops
            print(f"  one decode step ({cfg.n_layers} layers, 6 slots) "
                  f"dispatches {ops['total']} aten ops")
            del srv
            torch.cuda.empty_cache()

    if "moe-full" in cells:
        del weights
        gc.collect()
        torch.cuda.empty_cache()
        mcfg = cs.moe_full_config()

        def moe_traffic(seed):
            prompts, _ = cs.workload(mcfg.vocab_size, seed=seed)
            return prompts, [SamplingParams(max_tokens=cs.P8_NEW)] * len(
                prompts)

        srv = cs.build_server(mcfg, True, dev, enable_placement=True,
                              placement_interval=4)
        moe_weights = srv.params
        if pairs:
            del srv
            pair_runs = capture_pairs(
                lambda pl: cs.build_server(
                    mcfg, True, dev, params=moe_weights, placement=pl,
                    enable_placement=True, placement_interval=4),
                moe_traffic, f"moe-full [{smi}]", pairs)
            srv = cs.build_server(mcfg, True, dev, params=moe_weights,
                                  enable_placement=True,
                                  placement_interval=4)
        rep["moe_full"] = profile(srv, moe_traffic, smi,
                                  "moe-full, qwen2-moe-a2.7b")
        if pairs:
            rep["moe_full"]["pairs"] = pair_runs
        rep["moe_full"]["peak_mem_gb"] = \
            torch.cuda.max_memory_allocated() / 1e9
        del srv
        torch.cuda.empty_cache()
    cs.OUT_DIR.mkdir(exist_ok=True)
    (cs.OUT_DIR / out_name).write_text(json.dumps(rep, indent=1))
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
