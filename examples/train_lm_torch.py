"""The PyTorch port's twin of ``examples/train_lm.py``: train a (reduced)
assigned architecture for a few hundred steps on the synthetic pipeline,
with checkpoint/restart via the fault supervisor, through
``repro_torch.launch.train`` -- on the CUDA card by default, through the
hand-written forward and backward kernels, or on the CPU with
``--device cpu`` (the kernels' plain versions).

    python examples/train_lm_torch.py [--arch internlm2-1.8b]
    python examples/train_lm_torch.py --arch rwkv6-3b --device cpu
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.train import train


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    with tempfile.TemporaryDirectory() as ckpt:
        # finite corpus (documents repeat) so the synthetic stream has
        # learnable statistics
        out = train(args.arch, steps=args.steps, batch=args.batch,
                    seq=args.seq, smoke=True, ckpt_dir=ckpt,
                    ckpt_every=max(args.steps // 4, 10), num_docs=48,
                    device=args.device)
        losses = out["losses"]
        k = max(len(losses) // 8, 1)
        first, last = (sum(losses[:k]) / k, sum(losses[-k:]) / k)
        print(f"\n{args.arch}: loss {first:.3f} -> {last:.3f} "
              f"over {len(losses)} steps")
        assert last < first, "loss did not decrease"


if __name__ == "__main__":
    main()
