"""The decode kernel of a checkout timed whole and with its cross-split
merge cut out, to split its time into the runs and the merge.

    python3 tools/decode_merge_split.py [--tree DIR] [--out FILE]
                                        [--splits N,N,...] [--cut-at TEXT]

``--tree`` is the checkout whose ``src/repro_torch`` runs (default: this
one); an unpacked older commit works the same way.  Its
``kernels/csrc/decode_attention.cu`` is built twice with ``nvcc`` into
``DIR/build/merge_split/``: as it is, and with every ``if (!merges)
return;`` turned into ``return;``, so that each block still streams its run
and writes its partial state to the workspace and the last block of a
(slot, kv head) still counts itself and resets the counter, but merges
nothing.  The difference of the two times is the merge (the last block's
reads of every split's state and its output stores); the second time is the
runs, their workspace stores and the launch.  That line is the CUDA-core
kernel's (``decode_split``); the tensor-core kernel merges its splits in a
cluster, which ``--cut-at "The cluster's merge"`` cuts out.  Both are called through
``ctypes`` with the arguments the checkout's wrapper passes (its
``_grid``: splits, workspace, counters).  Each time is the median of 5
readings of 20 calls with CUDA events; the whole kernel's device time under
``torch.profiler`` is printed beside it (back-to-back calls of a kernel of
a few tens of microseconds can time the host path instead).

With ``--splits``, each shape is also timed whole at each of those split
counts (the C entry's ``n_splits``, in place of the wrapper's), to tune
the wrapper's choice.  Each ``--cut-at TEXT`` (repeatable) builds one more
variant, with ``return;`` put before the one source line that holds TEXT
(a comment in the kernel, say), to time the kernel up to that line.

Shapes, bf16, softcap 0, no window: one block of Jamba-1.5-Large's layer
(1 slot, 64 q / 8 kv heads of 128, 262,144 rows, all admitted; the
whole-cache entry and the entry over a block of positions), and over
``chip_smoke.py`` phase 6's 8 ragged slots of 8,192 rows: PaliGemma-3B's
8 / 1 heads of 256, a group of 16 (16 / 1 heads of 128) and Granite-8B's
32 / 8 heads of 128.  Needs a CUDA card; prints one JSON line per shape
and the card's ``nvidia-smi`` line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

#: (label, slots, q heads, kv heads, head_dim, rows, ragged, partial)
SHAPES = (
    ("jamba block", 1, 64, 8, 128, 262144, False, False),
    ("jamba block partial", 1, 64, 8, 128, 262144, False, True),
    ("paligemma hd 256", 8, 8, 1, 256, 8192, True, False),
    ("group 16", 8, 16, 1, 128, 8192, True, False),
    ("granite G 4", 8, 32, 8, 128, 8192, True, False),
)


def median_ms(torch, fn, readings=5, reps=20):
    out = []
    for _ in range(readings):
        fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1) / reps)
    return float(np.median(out))


def device_ms(torch, fn, reps=20):
    """The device time of one call of ``fn`` under ``torch.profiler``
    (every CUDA kernel's own time, summed, over ``reps`` calls)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "self_device_time_total", 0)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               ) / reps / 1e3


def build(tree, build_mod, name, cut=None):
    """The checkout's decode source built into a library ``name``: as it
    is, with the merge cut out (``cut`` "merge"), or with ``return;``
    before the line that holds ``cut``; returns the loaded library."""
    src = os.path.join(tree, "src", "repro_torch", "kernels", "csrc",
                       "decode_attention.cu")
    text = open(src).read()
    if cut == "merge":
        if "if (!merges) return;" not in text:
            raise SystemExit(f"{src} has no 'if (!merges) return;' to cut")
        text = text.replace("if (!merges) return;", "return;")
    elif cut:
        lines = text.split("\n")
        at = [i for i, ln in enumerate(lines) if cut in ln]
        if len(at) != 1:
            raise SystemExit(f"{src}: {len(at)} lines hold {cut!r}, not 1")
        lines.insert(at[0], "  return;")
        text = "\n".join(lines)
    out_dir = os.path.join(tree, "build", "merge_split")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(os.path.dirname(src), f".{name}.cu")
    with open(cu, "w") as f:
        f.write(text)
    lib = os.path.join(out_dir, f"lib{name}.so")
    try:
        done = subprocess.run([build_mod._nvcc(), *build_mod.NVCC_FLAGS,
                               "-o", lib, cu], capture_output=True, text=True)
    finally:
        os.remove(cu)
    if done.returncode:
        raise SystemExit(f"nvcc failed:\n{done.stderr}")
    return ctypes.PyDLL(lib)


def entry(lib, partial):
    """A launcher ``f(q, k, v, valid, o, lse, ws, counters, B, Hq, Hkv,
    kv_slot, S, hd, splits, stream)`` over the library's entry points: the
    one entry with a nullable lse, or the two older ones."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if hasattr(lib, "attn_decode"):
        fn = lib.attn_decode
        fn.argtypes = [P] * 8 + [I] * 9 + [F, I, P]
        fn.restype = I

        def call(q, k, v, valid, o, lse, ws, ctr, B, Hq, Hkv, slot, S, hd,
                 splits, stream):
            return fn(q, k, v, valid, o, lse if partial else None, ws, ctr,
                      B, Hq, Hkv, slot, S, 0, hd, 1, 0, 0.0, splits, stream)
        return call
    if partial:
        fn = lib.attn_decode_partial
        fn.argtypes = [P] * 8 + [I] * 9 + [F, I, P]
        fn.restype = I

        def call(q, k, v, valid, o, lse, ws, ctr, B, Hq, Hkv, slot, S, hd,
                 splits, stream):
            return fn(q, k, v, valid, o, lse, ws, ctr, B, Hq, Hkv, slot, S,
                      0, hd, 1, 0, 0.0, splits, stream)
        return call
    fn = lib.attn_decode_forward
    fn.argtypes = [P] * 7 + [I] * 8 + [F, I, P]
    fn.restype = I

    def call(q, k, v, valid, o, lse, ws, ctr, B, Hq, Hkv, slot, S, hd, splits,
             stream):
        return fn(q, k, v, valid, o, ws, ctr, B, Hq, Hkv, slot, S, hd, 1, 0,
                  0.0, splits, stream)
    return call


def main(argv=None) -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=here)
    parser.add_argument("--out", help="also append the JSON lines here")
    parser.add_argument("--splits", default="",
                        help="comma-separated split counts to time too")
    parser.add_argument("--cut-at", action="append", default=[],
                        help="time a variant cut before the line holding "
                             "this text (repeatable)")
    args = parser.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, os.path.join(tree, "src"))

    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    libs = {"whole": build(tree, _build, "decode_whole"),
            "no merge": build(tree, _build, "decode_no_merge", "merge")}
    for i, text in enumerate(args.cut_at):
        libs[f"cut at {text}"] = build(tree, _build, f"decode_cut{i}", text)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    rng = np.random.default_rng(6)
    ragged = np.sort(rng.integers(1, 8192 + 1, 8))
    ragged[0] = 1
    stream = torch.cuda.current_stream().cuda_stream
    lines = []
    for label, b, hq, hkv, hd, s_len, rag, partial in SHAPES:
        q = torch.randn((b, hq, hd), generator=gen, device=dev).bfloat16()
        ck, cv = (torch.randn((b, hkv, s_len, hd), generator=gen,
                              device=dev).bfloat16() for _ in range(2))
        valid = torch.as_tensor(
            (ragged if rag else np.full(b, s_len)).astype(np.int32),
            device=dev)
        o = torch.empty((b, hq, hd), device=dev,
                        dtype=torch.float32 if partial else torch.bfloat16)
        lse = torch.empty((b, hq), device=dev)
        splits, _, ctr = da._grid(dev.index or 0, q, ck)
        sweep = [int(n) for n in args.splits.split(",") if n]
        ws = torch.empty(b * hq * max([splits] + sweep) * (hd + 2),
                         device=dev)
        times, by_splits = {}, {}
        runs = [(v, lib, splits) for v, lib in libs.items()]
        runs += [("whole", libs["whole"], n) for n in sweep]
        for variant, lib, n_splits in runs:
            call = entry(lib, partial)
            ptrs = (q.data_ptr(), ck.data_ptr(), cv.data_ptr(),
                    valid.data_ptr(), o.data_ptr(), lse.data_ptr(),
                    ws.data_ptr(), ctr.data_ptr(), b, hq, hkv, hkv, s_len,
                    hd, n_splits, stream)

            def run():
                rc = call(*ptrs)
                if rc:
                    raise SystemExit(f"{label} {variant}: CUDA error {rc}")
            ms = median_ms(torch, run)
            if n_splits == splits and variant not in times:
                times[variant] = ms
                if variant == "whole":
                    whole_device = device_ms(torch, run)
            else:
                by_splits[n_splits] = ms
        line = dict(shape=label, slots=b, q_heads=hq, kv_heads=hkv,
                    head_dim=hd, rows=s_len,
                    valid_len=valid.tolist(), splits=splits,
                    ms_whole=times["whole"], device_ms_whole=whole_device,
                    ms_no_merge=times["no merge"],
                    merge_ms=times["whole"] - times["no merge"],
                    merge_share=1 - times["no merge"] / times["whole"],
                    ms_whole_by_splits=by_splits,
                    ms_cut={k: v for k, v in times.items()
                            if k.startswith("cut at")},
                    nvidia_smi=smi, tree=tree)
        print("[merge-split] " + json.dumps(line), flush=True)
        lines.append(line)
        del q, ck, cv
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
