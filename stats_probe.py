"""Times kernels 4 and 5 of a checkout of facet_tpu_torch, with chip_smoke.py's timers.

    python3 stats_probe.py TREE           # K4 and K5 (RGB entry): exactness, graph, by launch
    python3 stats_probe.py TREE --sass    # the compiled instruction mix of both kernels

TREE is a directory holding a ``facet_tpu_torch`` package: this checkout
(``.``), a parent unpacked with ``git archive``, or a scratch copy with one
change to a kernel (a variant, or a probe that leaves part of the work out).
It imports that tree's package, builds its kernels, says whether K4 and K5
match their twins on the scan's batch, and times both per call from a CUDA
graph and by launch (torch.profiler) on the scan's batch (24, 1024, 1536,
3) and on one near-uniform 24 MP photo. A probe's outputs differ from the
twins by design, so nothing here fails on a mismatch: chip_smoke.py is the
check. With ``--sass`` it disassembles the tree's kernel library
(``cuobjdump -sass``) and prints each stats kernel's instruction count by
opcode, and for K5's RGB kernel the length of every loop that converts
gray values (its row loops). Needs one NVIDIA GPU; run it on the card, one
tree per process.
"""

import collections
import importlib.util
import os
import re
import subprocess
import sys


def load(tree):
    sys.path.insert(0, os.path.abspath(tree))
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(here, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def time_kernels(smoke, name):
    import torch

    from facet_tpu_torch.ops import fused_stats, gray_stats

    rgb = smoke.stats_batch(24, 1024, 1536, seed=7)
    a, b = fused_stats.fused_stats(rgb), fused_stats.fused_stats_plain(rgb)
    ok4 = (torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
           and float((a[0] - b[0]).abs().max()) <= smoke.ENTROPY_TOL)
    ok5 = all(torch.equal(x, y) for x, y in zip(
        gray_stats.fused_gray_stats_rgb(rgb), gray_stats.fused_gray_stats_rgb_plain(rgb)))
    print(name, "exact K4", ok4, "K5", ok5, flush=True)
    del a, b
    for label, rgb in (("photos B=24", smoke.stats_batch(24, 1024, 1536, seed=1028)),
                       ("near-uniform 24MP", smoke.big_photo("near-uniform"))):
        for kernel, fn in (("K4", lambda: fused_stats.fused_stats(rgb)),
                           ("K5rgb", lambda: gray_stats.fused_gray_stats_rgb(rgb))):
            print(f"{name} {label} {kernel} graph {smoke.graph_ms(fn):.4f} split "
                  f"{smoke.split_line(smoke.device_split(fn))}", flush=True)


def sass(path):
    out = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", path],
                         capture_output=True, text=True, check=True).stdout
    for func in re.split(r"\n\s+Function : ", out):
        name = func.split("\n", 1)[0]
        if "gray_stats_kernel" not in name and "fused_stats_pass" not in name:
            continue
        ins = [(int(m.group(1), 16), m.group(2).strip()) for m in
               re.finditer(r"\n\s+/\*([0-9a-f]{4,5})\*/\s+(.*?);", func)]
        ops = [re.sub(r"^@!?U?P\w+\s+", "", t).split()[0].split(".")[0] for _, t in ins]
        print(name[:90], len(ins), dict(collections.Counter(ops).most_common(20)))
        if "gray_stats_kernelILi3" not in name:
            continue
        at = {addr: i for i, (addr, _) in enumerate(ins)}
        for i, (addr, text) in enumerate(ins):
            target = re.search(r"BRA (0x[0-9a-f]+)", text)
            start = at.get(int(target.group(1), 16)) if target else None
            if start is not None and start < i and ops[start:i + 1].count("IDP") >= 20:
                body = collections.Counter(ops[start:i + 1])
                print(f"  loop {hex(ins[start][0])}-{hex(addr)}: {i + 1 - start} instructions, "
                      f"{body['IDP']} dp4a, {body['ATOMS']} shared atomics")


def main():
    tree = sys.argv[1]
    smoke = load(tree)
    smoke.phase_device()
    from facet_tpu_torch.ops import cuda_build

    cuda_build.library()
    if sys.argv[2:] == ["--sass"]:
        sass(cuda_build.build_info["path"])
    else:
        time_kernels(smoke, os.path.basename(os.path.abspath(tree)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
