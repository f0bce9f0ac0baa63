#!/usr/bin/env python3
"""Times, digests and checks of the flash kernels (the forward, the forward
with lse, dQ and dK/dV) of one source tree, to compare two trees on one
card.

At the attention cells of ``chip_smoke.FLASH_CELLS`` (this checkout's; all
of them, in each cell's dtypes, or those of ``--cells`` and ``--dtypes``)
on seeded random inputs: nemotron_attn (hd 192), qwen3_attn and its
windowed cells (hd 128) and tinyllama_attn (hd 64).  The kernels come from
the ``repro_torch`` package of the tree given by ``--src``, which it
builds; it needs a CUDA card.  For each cell,
dtype and kernel: the median ms (CUDA events), the sha256 of each output
(o; o and lse; dq; dk and dv), and its element-wise mismatch against its
plain version at ``flash.KERNEL_TOL`` (the forward at the kernels' tile,
the backward ``flash_bwd_plain`` on the kernels' lse and delta; at most 1
holds); and for each instance of the four kernels ptxas's registers,
spills and coded notes and the card's shared bytes and blocks per SM.

    python3 scripts/flash_ab.py --src build/parent/src --out old.json
    python3 scripts/flash_ab.py --src src --out new.json
    python3 scripts/flash_ab.py --compare old.json new.json

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
INSTANCE = re.compile(r"(flash_(?:fwd|bwd_dq|bwd_dkv))(_tc|_ws)?_kernelIf?Li(\d+)E"
                      r"(?:Lb([01])E)?")


def digest(t) -> str:
    import torch
    bits = t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32)
    return hashlib.sha256(bits.cpu().numpy().tobytes()).hexdigest()


def run(src: str, cells, dtypes) -> dict:
    sys.path[:0] = [str(ROOT)]
    import chip_smoke
    sys.path.insert(0, str(pathlib.Path(src).resolve()))
    import torch
    from repro_torch.kernels import build, flash
    if not torch.cuda.is_available():
        raise SystemExit("flash_ab: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out = {"src": src, "device": smi, "rows": {}, "ptxas": {}}
    print(smi, flush=True)
    build.library("flash")
    for mangled, rep in build.ptxas_report("flash").items():
        m = INSTANCE.search(mangled)
        if not m:
            continue
        kname = "flash_fwd_stats" if m.group(4) == "1" else m.group(1)
        dtype = torch.bfloat16 if m.group(2) else torch.float32
        hd = int(m.group(3))
        rep = dict(rep, **flash.kernel_info(kname, dtype, hd))
        key = f"{kname} {str(dtype)[6:]} hd {hd}"
        out["ptxas"][key] = rep
        print(f"ptxas {key}: {rep}", flush=True)
    for cell in cells:
        B, H, KV, S, hd, window, cell_dtypes = chip_smoke.FLASH_CELLS[cell]
        for name in cell_dtypes:
            if dtypes and name not in dtypes:
                continue
            dt = getattr(torch, name)
            gen = torch.Generator(device="cuda").manual_seed(7)
            q, k, v, do = (torch.randn((B, n, S, hd), generator=gen, device="cuda")
                           .to(dt) for n in (H, KV, KV, H))
            with torch.no_grad():
                p_o, p_lse = flash.flash_attention_plain(
                    q, k, v, window, chunk=flash.KERNEL_TILE, return_lse=True)
            o, lse = flash.flash_fwd_with_stats(q, k, v, window)
            delta = flash.flash_delta(o, do)
            want = flash.flash_bwd_plain(q, k, v, do, lse, delta, window)
            pairs = B * H * chip_smoke.attn_pairs(S, window)
            kernels = {
                "flash_fwd": (lambda: (flash.flash_attention(q, k, v, window),),
                              (p_o,), 2),
                "flash_fwd_stats": (lambda: flash.flash_fwd_with_stats(q, k, v, window),
                                    (p_o, p_lse), 2),
                "flash_bwd_dq": (lambda: (flash.flash_bwd_dq(
                    q, k, v, do, lse, delta, window),), want[:1], 3),
                "flash_bwd_dkv": (lambda: flash.flash_bwd_dkv(
                    q, k, v, do, lse, delta, window), want[1:], 4),
            }
            for kname, (fn, wants, products) in kernels.items():
                got = fn()
                torch.cuda.synchronize()
                row = {
                    "sha256": [digest(g) for g in got],
                    "mismatch": max(flash.kernel_mismatch(g, w, *flash.KERNEL_TOL[g.dtype])
                                    for g, w in zip(got, wants)),
                    "finite": all(bool(torch.isfinite(g).all()) for g in got),
                    "ms": chip_smoke.cuda_ms(torch, fn, reps=20 if name == "bfloat16" else 5),
                    "bound_ms": 2.0 * products * pairs * hd
                    / chip_smoke.PEAK_OPS[name] * 1e3}
                row["ok"] = row["finite"] and row["mismatch"] <= 1
                out["rows"][f"{kname} {cell} {name}"] = row
                print(f"{kname} {cell} {name}: ms {row['ms']:.4f} bound "
                      f"{row['bound_ms']:.4f} mismatch {row['mismatch']:.3g} "
                      f"ok {row['ok']}", flush=True)
                del got
            del q, k, v, do, o, lse, delta, want, p_o, p_lse
            torch.cuda.empty_cache()
    return out


def compare(a: dict, b: dict) -> bool:
    ok = True
    print(f"A: {a['src']} ({a['device']}); B: {b['src']} ({b['device']})")
    for key in sorted(set(a["ptxas"]) | set(b["ptxas"])):
        ra, rb = a["ptxas"].get(key, {}), b["ptxas"].get(key, {})
        print(f"{key}: " + ", ".join(
            f"{f} {ra.get(f)} -> {rb.get(f)}" for f in
            ("registers", "spill_stores", "smem_bytes", "blocks_per_sm", "notes")))
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
    ap.add_argument("--cells", help="comma-separated cells (default: all)")
    ap.add_argument("--dtypes", help="comma-separated dtypes (default: each "
                                     "cell's own)")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"),
                    help="two result files to compare")
    args = ap.parse_args()
    if args.compare:
        a, b = (json.loads(pathlib.Path(p).read_text()) for p in args.compare)
        return 0 if compare(a, b) else 1
    sys.path[:0] = [str(ROOT)]
    import chip_smoke
    cells = args.cells.split(",") if args.cells else list(chip_smoke.FLASH_CELLS)
    out = run(args.src, cells, args.dtypes.split(",") if args.dtypes else None)
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(args.out).write_text(json.dumps(out, indent=1))
    return 0 if all(r["ok"] for r in out["rows"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
