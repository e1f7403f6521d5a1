"""Dry run of the port: every (architecture × shape × rank layout) cell's
step traced once on meta tensors, its cost counted for one rank and priced
against one NVIDIA H100 (launch/cost.py). The port's counterpart of the
reference's src/repro/launch/dryrun.py, which compiles each cell for 512
fake XLA devices, walks the HLO and prices a TPU v5e.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \
        [--arch ID ...] [--shape NAME ...] [--mesh-shape EPxTP] \
        [--out results/dryrun_torch] [--force] [--tag T] [--set key=value ...]

It never touches a card: nothing but meta tensors is made. One JSON record
a cell goes to <out>/ep<E>_tp<T>/<arch>__<shape>[__tag].json, with the
reference's fields where they mean something here (`status`,
`flops_per_device`, `bytes_per_device`, `collective_bytes_per_device`,
`memory_analysis`, `roofline.terms` / `dominant`, `model_flops_total`,
`useful_flops_ratio`) and the port's own: `min_bytes_per_device`, the
roofline's memory term; `fits`, whether the arguments and the peak-live
bytes fit the card's memory; `card`, the card whose datasheet peaks price
it. Every figure is a prediction from those peaks, not a measurement.

A train cell over several ranks traces one rank's step on its rows of the
global batch (`LM.batch_rows`), its backward's collectives and the
trainer's gradient reductions included. Under cfg.fsdp the rank's
parameters and moments hold 1 / ep of each leaf's d_model dim
(`LM.param_specs`), so the argument bytes are the sharded ones, and the
trace counts each layer's gather ("all-gather", again in the backward
under remat) and each gradient's "reduce-scatter". An encoder-only
architecture has no decode step, as in the reference."""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import cost as cost_mod
from repro_torch.launch.mesh import (DEFAULT_LAYOUTS, dry_ctx, layout_name,
                                     parse_mesh_shape)
from repro_torch.launch.specs import (batch_specs, decode_specs,
                                      param_specs, ref_batch_part,
                                      supports_shape)
from repro_torch.models.lm import LM
from repro_torch.training.optim import adamw_init
from repro_torch.training.trainer import make_train_step

def _shape(shape) -> ShapeConfig:
    return SHAPES[shape] if isinstance(shape, str) else shape


def build_cell(arch: str, shape, ctx, overrides: dict | None = None,
               cfg=None, device="meta", seed: int = 0) -> tuple:
    """→ (fn, args, lm, meta): the cell's step and its arguments for one
    rank of `ctx`. `shape` is a SHAPES name or a ShapeConfig; `cfg`, if
    given, replaces get_config(arch) (with `overrides` applied on top). On
    "meta" (the dry run) every argument is a meta tensor; on another device
    (one rank only) the same step gets real arguments: `LM.init(seed)`
    weights, AdamW moments, seeded random tokens / frames / patches and
    labels, a zero cache, the round-robin MoE tables."""
    cfg = cfg if cfg is not None else get_config(arch)
    if overrides:
        cfg = cfg.with_updates(**overrides)
    shape = _shape(shape)
    lm = LM.build(cfg, device=device, ctx=ctx)
    dry = lm.device.type == "meta"
    params = param_specs(lm) if dry else lm.init(seed)
    tables = lm.default_tables()
    real = None if dry else _RealInputs(cfg, lm.device, seed)
    if shape.kind == "train":
        opt = adamw_init(params, cfg.optimizer_dtype)
        step = make_train_step(lm)

        def fn(params, opt, batch, tables):
            return step(params, opt, batch, tables)
        batch = batch_specs(cfg, shape, ctx)
        args = (params, opt, batch if dry else real.batch(batch), tables)
    elif shape.kind == "prefill":
        def fn(params, batch, tables):
            cache, logits, _aux = lm.prefill(
                params, batch.get("tokens"), max_len=shape.seq_len,
                tables=tables, patches=batch.get("patches"),
                frames=batch.get("frames"))
            return cache, logits
        batch = batch_specs(cfg, shape, ctx)
        args = (params, batch if dry else real.batch(batch), tables)
    else:
        token, positions, cache = decode_specs(cfg, shape, ctx, lm)
        if not dry:
            token = real.batch({"tokens": token})["tokens"]
            positions = torch.full(positions.shape, shape.seq_len - 1,
                                   dtype=positions.dtype, device=lm.device)

        def fn(params, cache, token, positions, tables):
            new_cache, logits, _aux = lm.decode(params, cache, token,
                                                positions, tables=tables)
            return new_cache, logits
        args = (params, cache, token, positions, tables)
    meta = {"arch": arch, "shape": shape.name, "kind": shape.kind,
            "n_params": cfg.n_params(),
            "n_active_params": cfg.n_active_params(),
            "seq_len": shape.seq_len, "global_batch": shape.global_batch,
            "compute_dtype": cfg.compute_dtype,
            "ref_batch_part": ref_batch_part(ctx, shape.global_batch)}
    return fn, args, lm, meta


class _RealInputs:
    """Seeded real stand-ins for a batch's meta tensors: token ids and
    labels uniform over the vocabulary, frames and patches normal."""

    def __init__(self, cfg, device, seed):
        self.cfg, self.device = cfg, device
        self.gen = torch.Generator(device=device).manual_seed(int(seed))

    def batch(self, spec: dict) -> dict:
        out = {}
        for k, t in spec.items():
            if t.dtype.is_floating_point:
                out[k] = torch.randn(t.shape, generator=self.gen,
                                     device=self.device).to(t.dtype)
            else:
                out[k] = torch.randint(0, self.cfg.vocab_size, t.shape,
                                       generator=self.gen,
                                       device=self.device).to(t.dtype)
        return out


def model_flops(meta: dict) -> float:
    """6·N_active·tokens (train) / 2·N_active·tokens (inference)."""
    factor = 6.0 if meta["kind"] == "train" else 2.0
    tokens = meta["global_batch"] * (meta["seq_len"]
                                     if meta["kind"] != "decode" else 1)
    return factor * meta["n_active_params"] * tokens


def count_cell(fn, args) -> dict:
    """Trace fn(*args) once under a CostCounter → its record (launch/
    cost.py)."""
    with cost_mod.CostCounter(args) as counter:
        out = fn(*args)
    return counter.finish(out)


def card_record() -> dict:
    return {"name": cost_mod.CARD, "power_limit": cost_mod.CARD_POWER_LIMIT,
            "memory_bytes": cost_mod.CARD_MEMORY_BYTES,
            "hbm_bytes_s": cost_mod.HBM_BYTES_S,
            "peak_flops": {str(k).replace("torch.", ""): v
                           for k, v in cost_mod.PEAK_FLOPS.items()},
            "nvlink_bytes_s": cost_mod.NVLINK_BYTES_S,
            "source": "datasheet peaks (launch/cost.py), not measured"}


def dry_cell(arch: str, shape, layout: tuple = (1, 1),
             overrides: dict | None = None, cfg=None, rank: int = 0) -> dict:
    """One cell's record without writing it: status "ok", "skipped" (with
    its reason) or "error" (with the traceback)."""
    ep, tp = layout
    shape = _shape(shape)
    rec = {"arch": arch, "shape": shape.name, "mesh": layout_name(ep, tp),
           "layout": {"ep": ep, "tp": tp, "rank": rank},
           "overrides": overrides or {}, "card": card_record()}
    ok, why = supports_shape(cfg or get_config(arch), shape)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    try:
        t0 = time.time()
        fn, args, lm, meta = build_cell(arch, shape, dry_ctx(tp, ep, rank),
                                        overrides, cfg)
        counted = count_cell(fn, args)
        mf = model_flops(meta)
        flops_dev = counted["flops_per_device"]
        mem = counted["memory_analysis"]
        need = mem["argument_bytes"] + mem["peak_live_bytes"]
        rec.update(
            status="ok", chips=ep * tp, **meta, **counted,
            t_trace_s=round(time.time() - t0, 2),
            model_flops_total=mf, flops_total=flops_dev * ep * tp,
            useful_flops_ratio=(mf / (flops_dev * ep * tp))
            if flops_dev else None,
            fits=need <= cost_mod.CARD_MEMORY_BYTES,
            device_bytes_needed=need)
    except Exception as e:        # recorded: each one is a fault to fix
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    return rec


def run_cell(arch: str, shape_name: str, layout: tuple, out_dir: Path,
             force: bool = False, overrides: dict | None = None,
             tag: str = "") -> dict:
    """The cell's record, from <out_dir> where it is there already (and
    not an error) unless `force`; otherwise counted and written there."""
    ep, tp = layout
    suffix = f"__{tag}" if tag else ""
    out_path = (Path(out_dir) / layout_name(ep, tp)
                / f"{arch}__{shape_name}{suffix}.json")
    if out_path.exists() and not force:
        prev = json.loads(out_path.read_text())
        if prev.get("status") != "error":
            return prev
    out_path.parent.mkdir(parents=True, exist_ok=True)
    rec = dry_cell(arch, shape_name, layout, overrides)
    rec["tag"] = tag
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def _parse(v: str):
    if v in ("True", "true"):
        return True
    if v in ("False", "false"):
        return False
    for f in (int, float):
        try:
            return f(v)
        except ValueError:
            pass
    return v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="*", default=ARCH_IDS)
    ap.add_argument("--shape", nargs="*", default=list(SHAPES))
    ap.add_argument("--mesh-shape", default=None,
                    help="one layout EPxTP, e.g. 1x8 (default: "
                    + ", ".join(f"{e}x{t}" for e, t in DEFAULT_LAYOUTS)
                    + ")")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="", help="suffix for variant records")
    ap.add_argument("--set", nargs="*", default=[], dest="overrides",
                    help="config overrides key=value")
    args = ap.parse_args(argv)
    overrides = {k: _parse(v) for k, v in
                 (item.split("=", 1) for item in args.overrides)}
    layouts = ([parse_mesh_shape(args.mesh_shape)] if args.mesh_shape
               else list(DEFAULT_LAYOUTS))
    n_err = 0
    for arch in args.arch:
        for shape in args.shape:
            for layout in layouts:
                t0 = time.time()
                rec = run_cell(arch, shape, layout, Path(args.out),
                               force=args.force, overrides=overrides,
                               tag=args.tag)
                status = rec.get("status")
                extra = ""
                if status == "ok":
                    r, m = rec["roofline"], rec["memory_analysis"]
                    extra = (f" dominant={r['dominant']}"
                             f" compute={r['terms']['compute_s']:.4f}s"
                             f" mem={r['terms']['memory_s']:.4f}s"
                             f" coll={r['terms']['collective_s']:.4f}s"
                             f" args={m['argument_bytes'] / 1e9:.2f}GB"
                             f" peak={m['peak_live_bytes'] / 1e9:.2f}GB"
                             f" fits={rec['fits']}")
                elif status == "error":
                    n_err += 1
                    extra = " " + rec.get("error", "")[:160]
                else:
                    extra = " " + rec.get("reason", "")
                print(f"[{time.strftime('%H:%M:%S')}] {arch} x {shape} x "
                      f"{layout_name(*layout)}: {status}{extra} "
                      f"({time.time() - t0:.1f}s)", flush=True)
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
