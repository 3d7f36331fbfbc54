"""Training CLI (port of ground_plane_polling_tpu/bin/train.py): train a GPP
detector on a prepared KITTI split (train/ and val/ as prepare-data writes
them), on the card unless --device says otherwise.

  python -m ground_plane_polling_tpu_torch.bin.train --batch-size 2 \
      --epochs 50 --random-transform --bf16 --snapshot-path ./snapshots \
      kitti /data/kitti

The model is the seeded init (seed 0, as the JAX CLI's PRNGKey(0)) or
--weights x.npz (the JAX package's export) or x.h5 (a reference Keras
checkpoint, models/h5_import.py). --backbone-h5 lays a keras_resnet (or
keras.applications) backbone file over it, and --imagenet-weights takes
that file from the md5-checked cache of models/imagenet.py, fetching it
once where the machine has network. --snapshot auto resumes from
the newest checkpoint under --snapshot-path. Training steps prepare each batch (augmentation, anchor
targets) inside the step (--fused-prepare, the default) or in the loader's
producer thread (--no-fused-prepare); the validation sweep runs the
detector, polling kernel included, after each epoch. On the card each step
replays a CUDA graph captured at the first batch of its canvas shape
(training.train.CapturedTrainStep), as the JAX CLI's step is jitted;
with --data-parallel over NCCL the first 11 steps run eagerly (DDP's
warm-up) and the graph holds the gradients' all-reduce. On the CPU, and
over gloo, the step runs eagerly.

Data parallel: one process per card, each launched with
COORDINATOR_ADDRESS=host:port NUM_PROCESSES=N PROCESS_ID=r and
--data-parallel (rank r drives cuda:(r % cards); NCCL). --batch-size is
the global batch and must divide by N; only rank 0 writes the log, the
events and the checkpoints. One process, or no --data-parallel, trains on
its own.
"""

from __future__ import annotations

import argparse
import sys


def parse_args(argv):
    p = argparse.ArgumentParser(description="Train a GPP detector.")
    sub = p.add_subparsers(dest="dataset_type")
    kitti = sub.add_parser("kitti")
    kitti.add_argument("kitti_path",
                       help="Path to the prepared dataset (train/val dirs).")

    p.add_argument("--backbone", default="resnet50")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--steps", type=int, default=None,
                   help="Steps per epoch (default: full dataset).")
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--snapshot", default=None,
                   help="Resume from this checkpoint file, or 'auto' for "
                        "the newest under --snapshot-path.")
    p.add_argument("--snapshot-path", default="./snapshots")
    p.add_argument("--no-snapshots", action="store_true")
    p.add_argument("--snapshot-every", type=int, default=1,
                   help="checkpoint every N epochs (the last epoch always)")
    p.add_argument("--sync-snapshots", action="store_true",
                   help="save checkpoints synchronously (default: a writer "
                        "thread, after a copy on the device)")
    p.add_argument("--freeze-backbone", action="store_true")
    p.add_argument("--random-transform", action="store_true")
    p.add_argument("--image-min-side", type=int, default=800)
    p.add_argument("--image-max-side", type=int, default=1333)
    p.add_argument("--no-evaluation", action="store_true")
    p.add_argument("--weights", default=None,
                   help="Initialize from an exported .npz weight file or a "
                        "reference Keras .h5 checkpoint.")
    p.add_argument("--fused-prepare", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="augmentation + anchor targets inside the train "
                        "step (default); --no-fused-prepare prepares in the "
                        "loader's producer thread")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute under autocast (params stay f32); "
                        "without it float32 with TF32 off")
    p.add_argument("--log-path", default="training_log.jsonl")
    p.add_argument("--compat-height-only-dim-loss", action="store_true",
                   help="Reproduce the reference's height-only dim loss.")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "versions of the kernels)")
    p.add_argument("--data-parallel", action="store_true",
                   help="shard each batch over the processes of the "
                        "launch (COORDINATOR_ADDRESS, NUM_PROCESSES, "
                        "PROCESS_ID): one process per device")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize the backbone's blocks on the "
                        "backward pass: less memory, about one more "
                        "forward")
    p.add_argument("--tensorboard-dir", default=None,
                   help="also mirror each epoch's scalars into "
                        "TensorBoard event files")
    p.add_argument("--backbone-h5", default=None,
                   help="Initialize the backbone from a keras_resnet (or "
                        "keras.applications) h5; FPN and heads keep the "
                        "seeded init")
    p.add_argument("--imagenet-weights", action="store_true",
                   help="Initialize the backbone from the keras_resnet "
                        "ImageNet h5 (cached and md5-checked, fetched once "
                        "where the machine has network; otherwise use "
                        "--backbone-h5 with a file fetched elsewhere)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv if argv is not None else sys.argv[1:])
    if args.dataset_type != "kitti":
        raise SystemExit("only the kitti dataset is supported (like the "
                         "reference's implemented subset)")

    import torch

    from ..data.kitti import KittiDataset
    from ..data.pipeline import KittiLoader
    from ..inference import require_device
    from ..models import (build_detector, export_jax_params, init_detector,
                          load_state, read_weights)
    from ..parallel import data_parallel_mesh, initialize, is_multi_host
    from ..training.checkpoint import latest_checkpoint, restore_checkpoint
    from ..training.loop import fit
    from ..training.train import (create_train_state, make_fused_train_step,
                                  make_optimizer, make_train_step)

    device = require_device(args.device)
    initialize(device=device)  # a no-op without a multi-process launch
    mesh = None
    if args.data_parallel and is_multi_host():
        mesh = data_parallel_mesh(device=device)
        device = mesh.device
    if not args.bf16:
        # float32 means float32: no TF32 in convs or matmuls
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    train_ds = KittiDataset(args.kitti_path, "train")
    train_loader = KittiLoader(
        train_ds, batch_size=args.batch_size,
        image_min_side=args.image_min_side,
        image_max_side=args.image_max_side,
        augment=args.random_transform,
        raw_batches=args.fused_prepare, device=device, mesh=mesh)
    val_loader = None
    if not args.no_evaluation:
        val_loader = KittiLoader(
            KittiDataset(args.kitti_path, "val"),
            image_min_side=args.image_min_side,
            image_max_side=args.image_max_side, shuffle=False, device=device)

    model = build_detector(args.backbone, num_classes=train_ds.num_classes,
                           remat=args.remat)
    if args.weights:
        load_state(model, read_weights(args.weights, args.backbone)[0],
                   args.weights)
    else:
        init_detector(model, 0)
    backbone_h5 = args.backbone_h5
    if args.imagenet_weights and not backbone_h5:
        from ..models.imagenet import download_imagenet

        backbone_h5 = download_imagenet(args.backbone)
    if backbone_h5:
        from ..models.h5_import import (flatten_variables, load_reference_h5,
                                        merge_backbone, unflatten_variables)

        merged = merge_backbone(
            unflatten_variables(export_jax_params(model)),
            load_reference_h5(backbone_h5, backbone=args.backbone,
                              backbone_only=True))
        load_state(model, flatten_variables(merged), backbone_h5)
    model = model.to(device)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    optimizer = make_optimizer(model, args.lr,
                               freeze_backbone=args.freeze_backbone)
    state = create_train_state(model, optimizer)
    if args.snapshot == "auto":
        latest = latest_checkpoint(args.snapshot_path)
        if latest:
            print(f"resuming from {latest}")
            state = restore_checkpoint(latest, state)
    elif args.snapshot:
        state = restore_checkpoint(args.snapshot, state)

    step_kwargs = dict(compat_height_only=args.compat_height_only_dim_loss,
                       bf16=args.bf16)
    if args.fused_prepare:
        step = make_fused_train_step(loader=train_loader, mesh=mesh,
                                     **step_kwargs)
    else:
        step = make_train_step(mesh=mesh, **step_kwargs)

    return fit(
        model, state, step, train_loader,
        epochs=args.epochs, steps_per_epoch=args.steps,
        val_loader=val_loader, num_classes=train_ds.num_classes,
        checkpoint_dir=None if args.no_snapshots else args.snapshot_path,
        checkpoint_every=args.snapshot_every, log_path=args.log_path,
        tensorboard_dir=args.tensorboard_dir, eval_mesh=mesh,
        async_checkpoints=not args.sync_snapshots)


if __name__ == "__main__":
    main()
