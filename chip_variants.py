"""Time edited builds of the attention, expert and block-score kernels
against this tree's, in one call on one NVIDIA GPU.

    python3 chip_variants.py [--kernels K1,K2] NAME=DIR [NAME=DIR ...]

Each DIR holds an edited copy of src/repro_torch/kernels/csrc (or a parent
commit's) with the same C entry points (a DIR may lack entry points this
tree added: the cases call only the ones both have). The script builds
`paged_prefill`, `spec_verify`, `paged_decode`, `sink_decode`, `moe_gmm`
and `block_topk` from this tree and from every DIR (one nvcc per source,
all at once), then, at chip_smoke.py's main and long shapes (paged_decode:
its main shape and phase 5's ring tables, float and int8 pages;
sink_decode: the ring and the full cache; moe_gmm: decode w1/w3 and w2 and
the prefill chunk, float32 and bf16; the paged-history kernels float32,
float and int8 pages; block_topk: the scores of phase 6's decode step,
float32 and bf16 queries),
times each variant against this tree in turns (this, variant, variant,
this; device time, chip_smoke.Timer) and reports its largest difference
from this tree's output. A variant may be wrong on purpose (to time a
part by leaving it out): the difference is reported, not checked. This
tree's output is held against the plain version at the unchanged
tolerance. `--kernels` limits the build and the cases to the kernels
named (a parent commit whose other kernels have other entry points).
Results go to chiprun_out/chip_variants.json; the card's name
and power limit are printed with them. Exits non-zero without a CUDA
device.
"""
from __future__ import annotations

import ctypes
import functools
import json
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs

NAMES = ("paged_prefill", "spec_verify", "paged_decode", "sink_decode",
         "moe_gmm", "block_topk")


def build_variants(dirs: dict, names) -> dict:
    """{name: Path} → {name: {kernel: ctypes.CDLL}} (nvcc all at once)."""
    from repro_torch.kernels import build
    procs = {}
    for name, d in dirs.items():
        for k in names:
            out = d / f"lib{k}.so"
            procs[name, k] = (out, subprocess.Popen(
                [build._nvcc(), *build.ARCH_FLAGS, *build.NVCC_FLAGS, "-I",
                 str(d), "-o", str(out), str(d / f"{k}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs: dict = {}
    for (name, k), (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}/{k}: nvcc failed:\n{log}")
        lib = ctypes.CDLL(str(out))
        for fn, argtypes in build.SIGNATURES[k].items():
            if not hasattr(lib, fn):            # an older tree's library
                continue
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs.setdefault(name, {})[k] = lib
    return libs


def cases(dev):
    """(label, kernel, args, scale plane) at chip_smoke's shapes."""
    out = []
    g = torch.Generator(device=dev).manual_seed(6)
    for W, ts in cs.SINK_MAIN:
        q = torch.randn((6, 2, 6, 128), generator=g, device=dev)
        kc, vc = (torch.randn((6, W, 2, 128), generator=g, device=dev)
                  .transpose(1, 2) for _ in range(2))
        t = torch.tensor(ts, dtype=torch.int32, device=dev)
        out.append((f"sink_decode W={W}", "sink_decode", (q, kc, vc, t), {}))
    for dtype in (torch.float32, torch.bfloat16):
        for key, (C, D, F, n_tok) in (("w1", cs.MOE_DECODE),
                                      ("w2", cs.MOE_DECODE_W2),
                                      ("chunk", cs.MOE_PREFILL)):
            a = cs.moe_gmm_inputs(dev, dtype, 60, C, D, F, n_tok, 4, 30)
            out.append((f"moe_gmm {key} {str(dtype)[6:]}", "moe_gmm", a, {}))
    nbt, lens_t = cs.TOPK_MAIN
    for dtype in (torch.float32, torch.bfloat16):
        a = cs.topk_inputs(dev, dtype, 6, 2, 6, 128, 16, nbt, cs.P6_BLOCKS,
                           lens_t, 10)
        out.append((f"block_topk main {str(dtype)[6:]}", "block_topk", a,
                    {}))
    for label, nb, lens, seed in (
            ("main", 32, [1, 17, 100, 255, 448, 512], 3),
            ("ring", *cs.RING_MAIN, 6)):
        N = 6 * nb + 1
        a = cs.decode_inputs(dev, torch.float32, 6, 2, 6, 128, 16, nb, N,
                             lens, seed)
        out.append((f"paged_decode {label}", "paged_decode", a, {}))
        kq, vq, sc = cs.int8_arena(dev, 2, 16, 128, N, a[3], a[4], seed + 1)
        out.append((f"paged_decode {label} int8", "paged_decode",
                    (a[0], kq, vq, a[3], a[4]), sc))
    for label, kern, B, S, nb, offs, seed in (
            ("main", "paged_prefill", 1, 128, 32, [384], 4),
            ("long", "paged_prefill", 1, 128, cs.PREFILL_LONG[0],
             [cs.PREFILL_LONG[1]], 15),
            ("main", "spec_verify", 6, cs.P7_K + 1, cs.SPEC_MAIN[0],
             cs.SPEC_MAIN[1], 11),
            ("long", "spec_verify", 6, cs.P7_K + 1, cs.SPEC_LONG[0],
             cs.SPEC_LONG[1], 11)):
        N = B * nb + 1
        a = cs.prefill_inputs(dev, torch.float32, B, 2, S, 6, 128, 16, nb,
                              N, offs, [S] * B, seed)
        out.append((f"{kern} {label}", kern, a, {}))
        kq, vq, sc = cs.int8_arena(dev, 2, 16, 128, N, a[5], a[6], seed + 1)
        out.append((f"{kern} {label} int8", kern,
                    (a[0], a[1], a[2], kq, vq, a[5], a[6], a[7]), sc))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device", file=sys.stderr)
        return 1
    args, names = sys.argv[1:], NAMES
    if args[:1] == ["--kernels"] and len(args) > 1:
        names = tuple(args[1].split(","))
        args = args[2:]
    dirs = {}
    for arg in args:
        name, _, d = arg.partition("=")
        dirs[name] = Path(d).resolve()
    if not dirs or not all(d.is_dir() for d in dirs.values()) or \
            not set(names) <= set(NAMES):
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(cs.ROOT / "src"))
    from repro_torch.device import set_precision_policy
    from repro_torch.kernels import build
    from repro_torch.kernels.block_topk import (block_topk_scores,
                                                block_topk_scores_plain)
    from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_plain
    from repro_torch.kernels.paged_decode import (paged_decode,
                                                  paged_decode_plain)
    from repro_torch.kernels.paged_prefill import (paged_prefill,
                                                   paged_prefill_plain)
    from repro_torch.kernels.sink_decode import sink_decode, sink_decode_plain
    from repro_torch.kernels.spec_verify import spec_verify, spec_verify_plain
    set_precision_policy()
    dev = torch.device("cuda")
    smi = cs.nvidia_smi()
    build.build_all(list(names))
    libs = {"this": {k: build.load(k) for k in names}} | \
        build_variants(dirs, names)
    fns = {"paged_decode": (paged_decode, paged_decode_plain),
           "sink_decode": (sink_decode, sink_decode_plain),
           "moe_gmm": (moe_gmm, moe_gmm_plain),
           "paged_prefill": (paged_prefill, paged_prefill_plain),
           "spec_verify": (spec_verify, spec_verify_plain),
           "block_topk": (functools.partial(block_topk_scores, block_size=16),
                          functools.partial(block_topk_scores_plain,
                                            block_size=16))}
    timer = cs.Timer(dev)
    report = {"gpu": smi, "cases": {}}
    for label, kern, args, sc in cases(dev):
        if kern not in names:
            continue
        fn, plain = fns[kern]

        def run(name, kern=kern, fn=fn, args=args, sc=sc):
            def call():
                build._loaded[kern] = libs[name][kern]
                return fn(*args, **sc)
            return call
        mine = run("this")()
        torch.cuda.synchronize()
        want = plain(*args, **sc)
        if kern in ("paged_decode", "sink_decode", "moe_gmm", "block_topk"):
            torch.testing.assert_close(mine.float(), want.float(),
                                       **cs.TOL[args[0].dtype], msg=label)
        else:
            G = args[0].shape[2] // args[1].shape[2]
            for b, c in enumerate(args[7].tolist()):
                torch.testing.assert_close(mine[b, :, :c * G],
                                           want[b, :, :c * G],
                                           **cs.TOL[torch.float32], msg=label)
        rec = {}
        for name in dirs:
            diff = float((run(name)().float() - mine.float()).abs().max())
            t = [timer(run("this")), timer(run(name)), timer(run(name)),
                 timer(run("this"))]
            rec[name] = {"this_ms": (t[0] + t[3]) / 2,
                         "ms": (t[1] + t[2]) / 2, "turns_ms": t,
                         "max_abs_diff": diff}
            print(f"{label}: this {rec[name]['this_ms']:.4f} ms, {name} "
                  f"{rec[name]['ms']:.4f} ms (max |diff| {diff:.3g}) [{smi}]")
        build._loaded[kern] = libs["this"][kern]
        report["cases"][label] = rec
    cs.OUT_DIR.mkdir(exist_ok=True)
    (cs.OUT_DIR / "chip_variants.json").write_text(json.dumps(report,
                                                              indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
