"""The paper's §4 limited-angle experiment through the PyTorch/CUDA port.

A thin CLI over ``repro_torch.launch.ct_train``: the hybrid CT-Net
(sinogram completion) + U-Net (image refinement) model trained with the
differentiable projector providing (a) the ill-posed inputs, (b) the
data-consistency loss during training and (c) the iterative refinement at
inference.  On the card every projection runs the port's CUDA kernels.

    PYTHONPATH=src python examples/train_limited_angle_torch.py                # on the GPU
    PYTHONPATH=src python examples/train_limited_angle_torch.py --device cpu \
        --steps 40 --size 32
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.ct_train import CTTrainer, TrainConfig  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--size", type=int, default=48)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--available-deg", type=float, default=60.0)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--dc-weight", type=float, default=0.1)
    ap.add_argument("--compute-dtype", type=str, default=None)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)

    cfg = TrainConfig(geometry="limited_angle", model="hybrid",
                      n=args.size, steps=args.steps, batch=args.batch,
                      available_deg=args.available_deg,
                      dc_weight=args.dc_weight, ckpt_dir=args.ckpt_dir,
                      compute_dtype=args.compute_dtype)
    trainer = CTTrainer(cfg, device=args.device)
    trainer.fit()

    # ---- inference with sinogram completion + DC refinement (paper Fig. 3)
    m = trainer.evaluate(n_test=4)
    print(f"\nheld-out ({args.available_deg:.0f}deg of 180) on {trainer.device}:")
    print(f"  network prediction : PSNR {m['psnr_net']:6.3f} dB  "
          f"SSIM {m['ssim_net']:.4f}")
    print(f"  + data consistency : PSNR {m['psnr_refined']:6.3f} dB  "
          f"SSIM {m['ssim_refined']:.4f}")
    print(f"  projection residual: {m['dc_net']:.4f} -> "
          f"{m['dc_refined']:.4f}")
    print("(the paper reports 35.486/0.905 -> 36.350/0.911 on luggage CT)")
    return m


if __name__ == "__main__":
    main()
