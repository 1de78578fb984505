#!/usr/bin/env python3
"""Build variants of the proxy kernels' tiling and time them on one GPU.

    python3 tools/proxy_probe.py --parent-csrc DIR [--out PATH]

Compiles ``src/repro_torch/csrc/binary_dot.cu`` as it stands and in a few
variants of its tile constants (rows a warp, stages of the ring, blocks an
SM the sign instance is compiled for), and the parent's ``binary_dot.cu``
from DIR, one nvcc each, in parallel.  Every build's sign and crumb kernels
are held bit for bit against their plain versions at ragged shapes, then
timed as device time (CUDA events around 10 back-to-back launches queued
behind a spin kernel, median of 5) at b=64, d'=1024 and n in {45,000,
1,000,000}, in turns: parent, each variant, each variant again in reverse
order, parent.  Prints the card's ``nvidia-smi`` name and power limit, the
ptxas register report of each build and one JSON line of the results.
Needs a CUDA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SPIN_CYCLES = 2_000_000
# name -> substitutions in the source's tile constants.
VARIANTS = {
    "this": {},
    "sign_warp_rows_32": {"kPlanes == 1 ? 64 : 32": "32"},
    "sign_3_blocks": {"kMinBlocks = 2;": "kMinBlocks = kPlanes == 1 ? 3 : 2;"},
    "4_stages": {"kStages = 3;": "kStages = 4;"},
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent-csrc", required=True)
    ap.add_argument("--out", default=None, help="also write the results here as JSON")
    args = ap.parse_args()

    import numpy as np
    import torch

    from repro_torch.kernels import binary_dot, cuda_build, ref

    if not torch.cuda.is_available():
        print("proxy_probe: needs a CUDA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    work = ROOT / "build" / "proxy_probe"
    work.mkdir(parents=True, exist_ok=True)
    text = (cuda_build.CSRC / "binary_dot.cu").read_text()
    sources = {"parent": Path(args.parent_csrc) / "binary_dot.cu"}
    for name, subs in VARIANTS.items():
        src = text
        for old, new in subs.items():
            if old not in src:
                raise RuntimeError(f"variant {name}: {old!r} is not in binary_dot.cu")
            src = src.replace(old, new)
        sources[name] = work / f"binary_dot_{name}.cu"
        sources[name].write_text(src)
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(work / f"lib_{name}.so"),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in sources.items()}
    entries = {}
    for name, proc in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"{name}: {line.strip()}")
        lib = ctypes.CDLL(str(work / f"lib_{name}.so"))
        entries[name] = {}
        for fn_name in ("sign_hamming", "crumb_affinity"):
            entry = getattr(lib, fn_name)
            entry.argtypes, entry.restype = binary_dot._ARGTYPES, ctypes.c_int
            entries[name][fn_name] = entry
    print(f"built {len(sources)} sources in {time.perf_counter() - t0:.1f} s", flush=True)

    binary_dot._entry("sign_hamming")
    fns = {"sign_hamming": (binary_dot.sign_hamming_cuda, ref.sign_hamming_ref, 8),
           "crumb_affinity": (binary_dot.crumb_affinity_cuda, ref.crumb_affinity_ref, 4)}

    def call(build: str, fn_name: str, codes, qcodes):
        saved = binary_dot._ENTRY[fn_name]
        binary_dot._ENTRY[fn_name] = entries[build][fn_name]
        try:
            return fns[fn_name][0](codes, qcodes)
        finally:
            binary_dot._ENTRY[fn_name] = saved

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(3)

    def codes_of(rows: int, width: int):
        return torch.from_numpy(rng.integers(0, 256, size=(rows, width), dtype=np.uint8)).to(dev)

    failures = []
    for fn_name, (_, plain, per_byte) in fns.items():
        for b, n, d_pad in ((1, 1, 1024), (7, 129, 1024), (64, 127, 1024), (65, 301, 1024),
                            (7, 301, 8), (7, 301, 16), (7, 301, 136), (7, 301, 4096),
                            (64, 45_000, 1024)):
            codes, qcodes = codes_of(n, d_pad // per_byte), codes_of(b, d_pad // per_byte)
            want = plain(codes, qcodes)
            for build in entries:
                if not torch.equal(call(build, fn_name, codes, qcodes), want):
                    failures.append(f"{build} {fn_name} b={b} n={n} d'={d_pad}")
    print(f"bit-equal to the plain versions: {not failures} {failures}", flush=True)

    def device_ms(fn, calls: int = 10, samples: int = 5) -> float:
        fn()
        torch.cuda.synchronize()
        spin, times = SPIN_CYCLES, []
        while len(times) < samples:
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            marks[0].record()
            torch.cuda._sleep(spin)
            marks[1].record()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            queued_ms = 1e3 * (time.perf_counter() - t0)
            marks[2].record()
            marks[2].synchronize()
            if queued_ms >= marks[0].elapsed_time(marks[1]):
                spin *= 2
                continue
            times.append(marks[1].elapsed_time(marks[2]) / calls)
        return sorted(times)[samples // 2]

    results = {}
    variants = list(VARIANTS)
    order = ["parent", *variants, *reversed(variants), "parent"]
    for fn_name, (_, _, per_byte) in fns.items():
        for n in (45_000, 1_000_000):
            codes, qcodes = codes_of(n, 1024 // per_byte), codes_of(64, 1024 // per_byte)
            times = {name: [] for name in entries}
            for build in order:
                times[build].append(device_ms(lambda: call(build, fn_name, codes, qcodes)))
            results[f"{fn_name}_{n}"] = times
            print(f"{fn_name} n={n}: " + ", ".join(
                f"{k} {' / '.join(f'{t:.4f}' for t in v)}" for k, v in times.items()), flush=True)
            del codes, qcodes
            torch.cuda.empty_cache()
    line = {"device_ms": results, "failures": failures}
    if args.out:
        Path(args.out).write_text(json.dumps(line, indent=2))
    print(json.dumps(line))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
