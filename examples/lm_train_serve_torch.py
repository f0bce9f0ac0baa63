"""The LM side through the PyTorch/CUDA port: train a reduced
assigned-architecture config with the port's training loop (AdamW,
checkpoints, resume), then serve greedy decodes from the trained weights.
On the card, sequences longer than 2048 tokens run the flash kernels.

    PYTHONPATH=src python examples/lm_train_serve_torch.py --arch qwen3-0.6b --steps 40
    PYTHONPATH=src python examples/lm_train_serve_torch.py --device cpu --steps 10
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.data.tokens import TokenPipeline  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.steps import make_serve_step  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.models import model as MD  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device, "lm_train_serve_torch")

    cfg = configs.get_smoke(args.arch)
    pipe = TokenPipeline(cfg.vocab_size, 128, 8)
    params, losses = train_loop(cfg, None, pipe, args.steps, args.ckpt_dir,
                                device=dev)
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")

    serve = make_serve_step(cfg)
    B, ctx = 2, 64
    cache = MD.init_cache(cfg, B, ctx, dev)
    tok = torch.zeros((B,), dtype=torch.int32, device=dev)
    out = []
    for t in range(16):
        tok, lg, cache = serve(params, cache, tok, t)
        out.append(int(tok[0]))
    print("greedy decode:", out)
    return losses, out


if __name__ == "__main__":
    main()
