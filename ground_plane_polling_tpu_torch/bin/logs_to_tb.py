"""Convert a training JSONL log into TensorBoard event files (port of
ground_plane_polling_tpu/bin/logs_to_tb.py).

The training loop writes JSONL as the source of truth (and mirrors it to
TensorBoard live with --tensorboard-dir); this converts an existing log
after the fact:

  python -m ground_plane_polling_tpu_torch.bin.logs_to_tb \
      training_log.jsonl tb/
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Convert a JSONL training log to TensorBoard events.")
    p.add_argument("jsonl_path")
    p.add_argument("logdir")
    p.add_argument("--step-key", default="epoch")
    args = p.parse_args(argv if argv is not None else sys.argv[1:])

    from ..utils.tensorboard import jsonl_to_tensorboard

    n = jsonl_to_tensorboard(args.jsonl_path, args.logdir,
                             step_key=args.step_key)
    print(f"wrote {n} records to {args.logdir}")
    return n


if __name__ == "__main__":
    main()
