"""Time edited builds of the paged-history kernels against this tree's, in
one call on one NVIDIA GPU.

    python3 chip_variants.py NAME=DIR [NAME=DIR ...]

Each DIR holds an edited copy of src/repro_torch/kernels/csrc with the same
C entry points. The script builds `paged_prefill` and `spec_verify` from
this tree and from every DIR (one nvcc per source, all at once), then, at
chip_smoke.py's main and long shapes (float32, float and int8 pages),
times each variant against this tree in turns (this, variant, variant,
this; device time, chip_smoke.Timer) and reports its largest difference
from this tree's output. A variant may be wrong on purpose (to time a
part by leaving it out): the difference is reported, not checked. This
tree's output is held against the plain version at the unchanged
tolerance. Results go to chiprun_out/chip_variants.json; the card's name
and power limit are printed with them. Exits non-zero without a CUDA
device.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs

NAMES = ("paged_prefill", "spec_verify")


def build_variants(dirs: dict) -> dict:
    """{name: Path} → {name: {kernel: ctypes.CDLL}} (nvcc all at once)."""
    from repro_torch.kernels import build
    procs = {}
    for name, d in dirs.items():
        for k in NAMES:
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
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs.setdefault(name, {})[k] = lib
    return libs


def cases(dev):
    """(label, kernel, args, scale plane) at chip_smoke's shapes."""
    out = []
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
    dirs = {}
    for arg in sys.argv[1:]:
        name, _, d = arg.partition("=")
        dirs[name] = Path(d).resolve()
    if not dirs or not all(d.is_dir() for d in dirs.values()):
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(cs.ROOT / "src"))
    from repro_torch.device import set_precision_policy
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_prefill import (paged_prefill,
                                                   paged_prefill_plain)
    from repro_torch.kernels.spec_verify import spec_verify, spec_verify_plain
    set_precision_policy()
    dev = torch.device("cuda")
    smi = cs.nvidia_smi()
    build.build_all(list(NAMES))
    libs = {"this": {k: build.load(k) for k in NAMES}} | build_variants(dirs)
    fns = {"paged_prefill": (paged_prefill, paged_prefill_plain),
           "spec_verify": (spec_verify, spec_verify_plain)}
    timer = cs.Timer(dev)
    report = {"gpu": smi, "cases": {}}
    for label, kern, args, sc in cases(dev):
        fn, plain = fns[kern]

        def run(name, kern=kern, fn=fn, args=args, sc=sc):
            def call():
                build._loaded[kern] = libs[name][kern]
                return fn(*args, **sc)
            return call
        mine = run("this")()
        torch.cuda.synchronize()
        G = args[0].shape[2] // args[1].shape[2]
        want = plain(*args, **sc)
        for b, c in enumerate(args[7].tolist()):
            torch.testing.assert_close(mine[b, :, :c * G], want[b, :, :c * G],
                                       **cs.TOL[torch.float32], msg=label)
        rec = {}
        for name in dirs:
            diff = float((run(name)() - mine).abs().max())
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
