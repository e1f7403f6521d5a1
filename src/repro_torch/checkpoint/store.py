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
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import torch

from repro_torch.tree import tree_items, tree_map

FORMAT = "repro_torch.checkpoint/1"


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


def _leaf_bytes(t: torch.Tensor) -> torch.Tensor:
    """The leaf's memory as a flat uint8 CPU tensor."""
    return t.detach().contiguous().cpu().reshape(-1).view(torch.uint8)


def save_checkpoint(directory, step: int, tree, *, chunk_mb: int = 1024,
                    extra: Optional[dict] = None,
                    compress: bool = False) -> Path:
    """Atomic save of a tree of tensors (dicts, lists, tuples). Returns the
    committed path."""
    directory = Path(directory)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"format": FORMAT, "step": step, "leaves": {},
                "extra": extra or {}}
    chunk_id, f = -1, None
    try:
        for key, leaf in tree_items(tree):
            if f is None or f.tell() >= chunk_mb << 20:
                if f is not None:
                    f.close()
                chunk_id += 1
                fn = f"chunk_{chunk_id:05d}.bin"
                f = open(tmp / fn, "wb")
            raw = _leaf_bytes(leaf).numpy()
            data = zlib.compress(raw, 1) if compress else memoryview(raw)
            manifest["leaves"][key] = {
                "file": fn, "offset": f.tell(), "nbytes": len(data),
                "shape": list(leaf.shape), "dtype": _dtype_name(leaf.dtype),
                "codec": "zlib" if compress else "raw"}
            f.write(data)
    finally:
        if f is not None:
            f.close()
    with open(tmp / "manifest.json", "w") as mf:
        json.dump(manifest, mf)
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)         # atomic commit
    return final


def _committed_steps(directory: Path) -> list:
    return sorted(int(p.name.split("_")[1]) for p in directory.iterdir()
                  if p.is_dir() and p.name.startswith("step_")
                  and not p.name.endswith(".tmp"))


def _read_leaf(ckpt: Path, info: dict) -> torch.Tensor:
    dt = getattr(torch, info["dtype"])
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
    return buf.view(dt).reshape(info["shape"])


def load_checkpoint(directory, step: Optional[int] = None, *, template=None,
                    device=None):
    """Restore → (tree, step, extra); `step` None → the latest committed
    one. Without `template` the tree is the flat {key: tensor}. With
    `template` (a tree of tensors, "meta" ones included) the stored leaves
    fill its structure, each cast to the template leaf's dtype; a leaf the
    checkpoint lacks raises KeyError. Leaves go to `device` (None → the
    CPU)."""
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
    """Keep-last-N rotation + resume + crash-garbage cleanup."""
    directory: Path
    keep: int = 3

    def __post_init__(self):
        self.directory = Path(self.directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        for p in self.directory.glob("*.tmp"):    # crashed writes
            shutil.rmtree(p, ignore_errors=True)

    def save(self, step: int, tree, extra: Optional[dict] = None) -> Path:
        path = save_checkpoint(self.directory, step, tree, extra=extra)
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
                               device=device)
