"""Fault-tolerant checkpoints of the port: raw chunk files + a manifest,
committed by one atomic rename; the standard library only.

Layout of one checkpoint:
  <dir>/step_00000123/
    chunk_00000.bin        leaves' raw bytes back to back, ≤ chunk_mb each
    manifest.json          key → (file, offset, nbytes, shape, dtype,
                           codec), written last

The format is the port's own: the reference (src/repro/checkpoint/store.py)
packs msgpack chunks under zstd, and neither package reads the other's
checkpoints. A leaf's bytes are its tensor's memory as it is, so every
dtype — bfloat16 included, which numpy lacks — round-trips bit for bit;
`compress=True` deflates each leaf with zlib (off by default: random
float weights do not compress).

Crash safety: everything is written into `step_X.tmp/` and committed with
a single `os.rename` to `step_X/`; a crash mid-write leaves a .tmp
directory, which restore ignores and `CheckpointManager` removes. Restore
places each leaf on the caller's `device`, cast to the template's dtype
(the one-device form of the reference's elastic restore).

Over ranks (`lm`, an LM of world > 1; the reference stores whole leaves
and restores them onto any mesh): each rank writes the parts it owns of
every parameter-shaped subtree (a dict with "layers": the parameters,
each AdamW moment) into its own chunk files, `rank<r>_chunk_<i>.bin`, a
part several ranks hold alike by the first of them
(`DevicePlacement.rank_parts`), and rank 0 writes every other leaf
whole. After a barrier rank 0 merges the ranks' entries into one
manifest of whole one-rank leaves, each a list of parts with its cut in
the one-rank tree's coordinates ("parts"; an expert slot leaf's rows at
their experts' one-rank slots), and commits; a barrier follows, so the
commit is done when any rank goes on. Nothing crosses the process group
but the barriers. A restore assembles the whole leaves from their parts
(`load_checkpoint` without `lm` gives the one-rank tree) and, with `lm`,
cuts each parameter-shaped subtree to this rank's part by the current
layout's `param_cuts` (`DevicePlacement.place_params`): a checkpoint
saved on one layout restores onto any other (elastic).
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional

import torch

from repro_torch.tree import tree_items, tree_map

FORMAT = "repro_torch.checkpoint/1"


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


def _leaf_bytes(t: torch.Tensor) -> torch.Tensor:
    """The leaf's memory as a flat uint8 CPU tensor."""
    return t.detach().contiguous().cpu().reshape(-1).view(torch.uint8)


def _placement(lm, device=None):
    from repro_torch.serving.placement import DevicePlacement
    return DevicePlacement(torch.device(device) if device is not None
                           else lm.device, False, lm.ctx)


def _over_params(tree, fn):
    """fn applied to every parameter-shaped subtree (a dict with "layers")
    of `tree`; every other leaf as it is."""
    if isinstance(tree, dict) and "layers" in tree:
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _over_params(v, fn) for k, v in tree.items()}
    return tree


def _barrier(ctx) -> None:
    """Every rank of ctx's world waits here: a psum over `model`, then
    over `data` (the second waits for every rank's first), read back on
    the host — under NCCL a collective returns once it is enqueued on the
    card, so without the read a rank would run ahead of the others."""
    t = torch.zeros(1, device=ctx.host_device)
    ctx.psum_batch(ctx.psum_model(t)).cpu()


def _write_leaves(tmp: Path, prefix: str, items, chunk_mb: int,
                  compress: bool) -> list:
    """Write (key, tensor) items back to back into chunk files
    `<prefix>chunk_<i>.bin` under tmp, a new one past chunk_mb → their
    entries {"file", "offset", "nbytes", "codec"}, in order."""
    out, chunk_id, f = [], -1, None
    try:
        for _key, leaf in items:
            if f is None or f.tell() >= chunk_mb << 20:
                if f is not None:
                    f.close()
                chunk_id += 1
                fn = f"{prefix}chunk_{chunk_id:05d}.bin"
                f = open(tmp / fn, "wb")
            raw = _leaf_bytes(leaf).numpy()
            data = zlib.compress(raw, 1) if compress else memoryview(raw)
            out.append({"file": fn, "offset": f.tell(), "nbytes": len(data),
                        "codec": "zlib" if compress else "raw"})
            f.write(data)
    finally:
        if f is not None:
            f.close()
    return out


def _commit(directory: Path, step: int, tmp: Path, manifest: dict) -> Path:
    final = directory / f"step_{step:08d}"
    with open(tmp / "manifest.json", "w") as mf:
        json.dump(manifest, mf)
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)         # atomic commit
    return final


def save_checkpoint(directory, step: int, tree, *, chunk_mb: int = 1024,
                    extra: Optional[dict] = None,
                    compress: bool = False, lm=None) -> Path:
    """Atomic save of a tree of tensors (dicts, lists, tuples). Returns the
    committed path. With `lm` over several ranks every rank calls it with
    its parts (the module docstring)."""
    if lm is not None and lm.ctx.world > 1:
        return _save_sharded(Path(directory), step, tree, lm, chunk_mb,
                             extra, compress)
    directory = Path(directory)
    tmp = directory / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    items = tree_items(tree)
    entries = _write_leaves(tmp, "", items, chunk_mb, compress)
    leaves = {key: dict(e, shape=list(leaf.shape),
                        dtype=_dtype_name(leaf.dtype))
              for (key, leaf), e in zip(items, entries)}
    return _commit(directory, step, tmp, {"format": FORMAT, "step": step,
                                          "leaves": leaves,
                                          "extra": extra or {}})


def _save_sharded(directory: Path, step: int, tree, lm, chunk_mb: int,
                  extra: Optional[dict], compress: bool) -> Path:
    ctx = lm.ctx
    tmp = directory / f"step_{step:08d}.tmp"
    if ctx.rank == 0:
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
    _barrier(ctx)
    pl = _placement(lm)
    parts = []                    # (key, part, cut, whole shape)

    def walk(t, prefix):
        if isinstance(t, dict) and "layers" in t:
            parts.extend((f"{prefix}/{k}", v, c, shp)
                         for k, v, c, shp in pl.rank_parts(lm, t))
        elif isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}/{k}" if prefix else str(k))
        elif ctx.rank == 0:
            parts.extend((k, v, (None,) * v.ndim, tuple(v.shape))
                         for k, v in tree_items(t, prefix))
    walk(tree, "")
    entries = _write_leaves(tmp, f"rank{ctx.rank:05d}_",
                            [(k, v) for k, v, _, _ in parts], chunk_mb,
                            compress)
    mine = {k: {"shape": list(shp), "dtype": _dtype_name(v.dtype),
                "parts": [dict(e, shape=list(v.shape), cut=list(c))]}
            for (k, v, c, shp), e in zip(parts, entries)}
    (tmp / f"rank{ctx.rank:05d}.json").write_text(json.dumps(mine))
    _barrier(ctx)
    final = directory / f"step_{step:08d}"
    if ctx.rank == 0:
        leaves: dict = {}
        for r in range(ctx.world):
            f = tmp / f"rank{r:05d}.json"
            for k, v in json.loads(f.read_text()).items():
                leaves.setdefault(k, dict(v, parts=[]))["parts"] += \
                    v["parts"]
            f.unlink()
        _commit(directory, step, tmp, {
            "format": FORMAT, "step": step, "leaves": leaves,
            "extra": dict(extra or {}, saved_tp=ctx.tp, saved_ep=ctx.ep)})
    _barrier(ctx)
    return final


def _committed_steps(directory: Path) -> list:
    return sorted(int(p.name.split("_")[1]) for p in directory.iterdir()
                  if p.is_dir() and p.name.startswith("step_")
                  and not p.name.endswith(".tmp"))


def _read_bytes(ckpt: Path, info: dict, dt, shape) -> torch.Tensor:
    with open(ckpt / info["file"], "rb") as f:
        f.seek(info["offset"])
        if info["codec"] == "zlib":
            raw = bytearray(zlib.decompress(f.read(info["nbytes"])))
            buf = torch.frombuffer(raw, dtype=torch.uint8) if raw else \
                torch.empty(0, dtype=torch.uint8)
        else:
            buf = torch.empty(info["nbytes"], dtype=torch.uint8)
            if f.readinto(buf.numpy()) != info["nbytes"]:
                raise IOError(f"{ckpt / info['file']}: short read")
    return buf.view(dt).reshape(shape)


def _read_leaf(ckpt: Path, info: dict) -> torch.Tensor:
    """A whole leaf: its bytes, or its parts laid at their cuts (a leaf
    saved over ranks; what no part covers, an empty expert slot, is
    zeros)."""
    dt = getattr(torch, info["dtype"])
    if "parts" not in info:
        return _read_bytes(ckpt, info, dt, info["shape"])
    out = torch.zeros(info["shape"], dtype=dt)
    for p in info["parts"]:
        idx = tuple(slice(None) if c is None else slice(c[0], c[0] + c[1])
                    for c in p["cut"])
        out[idx] = _read_bytes(ckpt, p, dt, p["shape"])
    return out


def load_checkpoint(directory, step: Optional[int] = None, *, template=None,
                    device=None, lm=None):
    """Restore → (tree, step, extra); `step` None → the latest committed
    one. Without `template` the tree is the flat {key: tensor}. With
    `template` (a tree of tensors, "meta" ones included) the stored leaves
    fill its structure, each cast to the template leaf's dtype; a leaf the
    checkpoint lacks raises KeyError. Leaves go to `device` (None → the
    CPU). With `lm` over several ranks the template is this rank's
    (`LM.shapes()`, its moments) and every parameter-shaped subtree of the
    stored whole leaves is cut to this rank's part (`param_cuts`)."""
    if lm is not None and lm.ctx.world > 1:
        tree, step, extra = load_checkpoint(directory, step,
                                            template=template)
        pl = _placement(lm, device)
        tree = _over_params(tree, lambda t: pl.place_params(t, lm))
        tree = tree_map(lambda t: t.to(pl.device)
                        if isinstance(t, torch.Tensor) else t, tree)
        return tree, step, extra
    directory = Path(directory)
    if step is None:
        steps = _committed_steps(directory)
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {directory}")
        step = steps[-1]
    ckpt = directory / f"step_{step:08d}"
    manifest = json.loads((ckpt / "manifest.json").read_text())
    leaves = manifest["leaves"]
    dev = torch.device("cpu" if device is None else device)
    if template is None:
        flat = {k: _read_leaf(ckpt, info).to(dev)
                for k, info in leaves.items()}
        return flat, step, manifest["extra"]
    missing = [k for k, _ in tree_items(template) if k not in leaves]
    if missing:
        raise KeyError(f"checkpoint missing leaves: {missing[:5]} ...")
    keys = iter(k for k, _ in tree_items(template))

    def restore(tmpl):
        t = _read_leaf(ckpt, leaves[next(keys)])
        return t.to(device=dev, dtype=getattr(tmpl, "dtype", t.dtype))
    return tree_map(restore, template), step, manifest["extra"]


@dataclass
class CheckpointManager:
    """Keep-last-N rotation + resume + crash-garbage cleanup. With `lm`
    over several ranks (every rank builds one) saves and restores are
    sharded as `save_checkpoint` / `load_checkpoint` say, and rank 0 alone
    cleans and rotates."""
    directory: Path
    keep: int = 3
    lm: Any = None

    @property
    def _writer(self) -> bool:
        return self.lm is None or self.lm.ctx.rank == 0

    def __post_init__(self):
        self.directory = Path(self.directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        if self._writer:
            for p in self.directory.glob("*.tmp"):    # crashed writes
                shutil.rmtree(p, ignore_errors=True)

    def save(self, step: int, tree, extra: Optional[dict] = None) -> Path:
        path = save_checkpoint(self.directory, step, tree, extra=extra,
                               lm=self.lm)
        if self._writer:
            ckpts = sorted(p for p in self.directory.iterdir()
                           if p.is_dir() and not p.name.endswith(".tmp"))
            for old in ckpts[:-self.keep]:
                shutil.rmtree(old, ignore_errors=True)
        return path

    def latest_step(self) -> Optional[int]:
        steps = _committed_steps(self.directory)
        return steps[-1] if steps else None

    def restore(self, template=None, device=None):
        return load_checkpoint(self.directory, template=template,
                               device=device, lm=self.lm)
