#!/usr/bin/env python3
"""Times, digests and checks of the bf16 flash backward kernels (dQ and
dK/dV) of one source tree, to compare two trees on one card.

At the attention cells of ``chip_smoke.FLASH_CELLS`` (this checkout's) that
the backward runs in bf16 without a window: nemotron_attn (hd 192),
qwen3_attn (hd 128) and tinyllama_attn (hd 64), on seeded random inputs.
The kernels come from the ``repro_torch`` package of the tree given by
``--src``, which it builds; it needs a CUDA card.  For each cell and kernel:
the median ms (CUDA events), the sha256 of each output, and its element-wise
mismatch against ``flash_bwd_plain`` at ``flash.KERNEL_TOL`` (at most 1
holds); and for each backward instance ptxas's registers and spills and
the card's shared bytes and blocks per SM.

    python3 scripts/flash_bwd_ab.py --src build/parent/src --out old.json
    python3 scripts/flash_bwd_ab.py --src src --out new.json
    python3 scripts/flash_bwd_ab.py --compare old.json new.json

Run the two trees in turns (old, new, new, old) in one call to the card.
``--compare`` prints each row of the first file beside the second's, with
whether the outputs' bits agree; it exits 1 if a check failed in either.
"""
import argparse
import hashlib
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELLS = ("nemotron_attn", "qwen3_attn", "tinyllama_attn")


def run(src: str) -> dict:
    sys.path[:0] = [str(ROOT)]
    import chip_smoke
    sys.path.insert(0, str(pathlib.Path(src).resolve()))
    import torch
    from repro_torch.kernels import build, flash
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_ab: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out = {"src": src, "device": smi, "rows": {}, "ptxas": {}}
    print(smi, flush=True)
    build.library("flash")
    for mangled, rep in build.ptxas_report("flash").items():
        m = re.search(r"flash_bwd_(dq|dkv)_tc_kernelILi(\d+)E", mangled)
        if m:
            kname, hd = f"flash_bwd_{m.group(1)}", int(m.group(2))
            rep = dict(rep, **flash.kernel_info(kname, torch.bfloat16, hd))
            out["ptxas"][f"{kname} hd {hd}"] = rep
            print(f"ptxas {kname} hd {hd}: {rep}", flush=True)
    for cell in CELLS:
        B, H, KV, S, hd, window, _ = chip_smoke.FLASH_CELLS[cell]
        gen = torch.Generator(device="cuda").manual_seed(7)
        q, k, v, do = (torch.randn((B, n, S, hd), generator=gen, device="cuda")
                       .to(torch.bfloat16) for n in (H, KV, KV, H))
        o, lse = flash.flash_fwd_with_stats(q, k, v, window)
        delta = flash.flash_delta(o, do)
        want = flash.flash_bwd_plain(q, k, v, do, lse, delta, window)
        tol = flash.KERNEL_TOL[torch.bfloat16]
        pairs = B * H * chip_smoke.attn_pairs(S, window)
        kernels = {
            "flash_bwd_dq": (lambda: (flash.flash_bwd_dq(
                q, k, v, do, lse, delta, window),), want[:1], 3),
            "flash_bwd_dkv": (lambda: flash.flash_bwd_dkv(
                q, k, v, do, lse, delta, window), want[1:], 4),
        }
        for kname, (fn, wants, products) in kernels.items():
            got = fn()
            torch.cuda.synchronize()
            row = {
                "sha256": [hashlib.sha256(g.view(torch.int16).cpu().numpy()
                                          .tobytes()).hexdigest() for g in got],
                "mismatch": max(flash.kernel_mismatch(g, w, *tol)
                                for g, w in zip(got, wants)),
                "finite": all(bool(torch.isfinite(g).all()) for g in got),
                "ms": chip_smoke.cuda_ms(torch, fn, reps=20),
                "bound_ms": 2.0 * products * pairs * hd
                / chip_smoke.PEAK_OPS["bfloat16"] * 1e3}
            row["ok"] = row["finite"] and row["mismatch"] <= 1
            out["rows"][f"{kname} {cell}"] = row
            print(f"{kname} {cell}: ms {row['ms']:.4f} bound {row['bound_ms']:.4f} "
                  f"mismatch {row['mismatch']:.3g} ok {row['ok']}", flush=True)
            del got
        del q, k, v, do, o, lse, delta, want
        torch.cuda.empty_cache()
    return out


def compare(a: dict, b: dict) -> bool:
    ok = True
    print(f"A: {a['src']} ({a['device']}); B: {b['src']} ({b['device']})")
    for key in sorted(set(a["ptxas"]) | set(b["ptxas"])):
        ra, rb = a["ptxas"].get(key, {}), b["ptxas"].get(key, {})
        print(f"{key}: " + ", ".join(
            f"{f} {ra.get(f)} -> {rb.get(f)}" for f in
            ("registers", "spill_stores", "smem_bytes", "blocks_per_sm")))
    for key in a["rows"]:
        ra, rb = a["rows"][key], b["rows"].get(key)
        if rb is None:
            print(f"{key}: missing in B")
            ok = False
            continue
        ok &= ra["ok"] and rb["ok"]
        print(f"{key}: ms {ra['ms']:.4f} -> {rb['ms']:.4f} "
              f"({rb['ms'] / ra['ms']:.3f}x), mismatch {ra['mismatch']:.3g} -> "
              f"{rb['mismatch']:.3g}, "
              f"{'same bits' if ra['sha256'] == rb['sha256'] else 'other bits'}")
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", help="the tree's src/ directory")
    ap.add_argument("--out", help="where to write the results (JSON)")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"),
                    help="two result files to compare")
    args = ap.parse_args()
    if args.compare:
        a, b = (json.loads(pathlib.Path(p).read_text()) for p in args.compare)
        return 0 if compare(a, b) else 1
    out = run(args.src)
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(args.out).write_text(json.dumps(out, indent=1))
    return 0 if all(r["ok"] for r in out["rows"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
