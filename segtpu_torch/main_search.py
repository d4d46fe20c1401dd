"""CLI entry point (counterpart: segtpu/main_search.py).

Subcommands: ``search`` (the NAS loop: per genotype, or with
``--supernet K`` the masked population, sharded over ``--pop-devices D``,
or with ``--fleet`` one genotype a device), ``train`` (a fixed
architecture), ``eval`` (mIoU over a manifest), ``infer`` (one image
through the served engine and its kernels), ``fidelity`` (the f32
engine's full-resolution logits against golden ``.npz`` files),
``bench`` (``segtpu_torch.bench``: the served call's images/s, with
``BENCH_ARCH`` defaulting to ``--arch``). Flags
are the JAX package's and map onto ``config.SearchConfig`` and
``train.TrainConfig``; every subcommand also takes ``--device`` (default
``cuda``, which raises where there is no card). ``main`` first points
the kernel build at its directory (``utils.cache``: ``SEGTPU_CACHE_DIR``,
``SEGTPU_NO_CACHE``).

Usage:
    python -m segtpu_torch.main_search search --synthetic --num-iters 5
    python -m segtpu_torch.main_search search --synthetic --supernet 8
    python -m segtpu_torch.main_search infer --arch arch0 --image img.npy
    python -m segtpu_torch.main_search fidelity --ckpt arch0.ckpt \
        --golden g0.npz --max-dlogit 1e-3
    python -m segtpu_torch.main_search bench --arch arch1
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import logging
import os


def _add_search_flags(p: argparse.ArgumentParser):
    from segtpu_torch.config import SearchConfig
    defaults = SearchConfig()
    p.add_argument("--data-root", default=defaults.data_root)
    p.add_argument("--train-list", default=defaults.train_list)
    p.add_argument("--val-list", default=defaults.val_list)
    p.add_argument("--num-classes", type=int, default=defaults.num_classes)
    p.add_argument("--crop-size", type=int, nargs=2,
                   default=list(defaults.crop_size))
    p.add_argument("--shorter-side", type=int, default=None)
    p.add_argument("--meta-train-prct", type=float,
                   default=defaults.meta_train_prct)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--batch-size", type=int, nargs=2,
                   default=list(defaults.batch_size))
    p.add_argument("--num-epochs", type=int, nargs=2,
                   default=list(defaults.num_epochs))
    p.add_argument("--enc-lr", type=float, default=defaults.enc_lr)
    p.add_argument("--dec-lr", type=float, default=defaults.dec_lr)
    p.add_argument("--enc-grad-clip", type=float,
                   default=defaults.enc_grad_clip)
    p.add_argument("--dec-grad-clip", type=float,
                   default=defaults.dec_grad_clip)
    p.add_argument("--dec-aux-weight", type=float,
                   default=defaults.dec_aux_weight)
    p.add_argument("--do-kd", action="store_true")
    p.add_argument("--kd-coeff", type=float, default=defaults.kd_coeff)
    p.add_argument("--no-polyak", dest="do_polyak", action="store_false")
    p.add_argument("--no-aux-cell", dest="aux_cell", action="store_false")
    p.add_argument("--agg-size", type=int, default=defaults.agg_size)
    p.add_argument("--sep-repeats", type=int, default=defaults.sep_repeats)
    p.add_argument("--ctrl-version", choices=["cvpr", "wacv"],
                   default=defaults.ctrl_version)
    p.add_argument("--ctrl-algo", choices=["reinforce", "ppo"],
                   default=defaults.ctrl_algo)
    p.add_argument("--ctrl-lr", type=float, default=defaults.ctrl_lr)
    p.add_argument("--ctrl-baseline-decay", type=float,
                   default=defaults.ctrl_baseline_decay)
    p.add_argument("--lstm-hidden-size", type=int,
                   default=defaults.lstm_hidden_size)
    p.add_argument("--op-size", type=int, default=defaults.op_size)
    p.add_argument("--num-iters", type=int, default=defaults.num_iters)
    p.add_argument("--supernet", type=int, default=0, metavar="K",
                   help="vectorized population search: K archs per round")
    p.add_argument("--pop-devices", type=int, default=0, metavar="D",
                   help="with --supernet: shard the K population samples "
                        "over D devices (on the CPU: D logical devices)")
    p.add_argument("--fleet", action="store_true",
                   help="per-device fleet search, one genotype per device "
                        "(every CUDA device; one worker on the CPU)")
    p.add_argument("--seed", type=int, default=defaults.seed)
    p.add_argument("--snapshot-dir", default=defaults.snapshot_dir)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--val-every", type=int, default=defaults.val_every)
    p.add_argument("--enc-ckpt", default=defaults.enc_ckpt)


def _add_device_flag(p: argparse.ArgumentParser):
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")


def _cfg_from_args(args):
    from segtpu_torch.config import SearchConfig
    fields = {f.name for f in dataclasses.fields(SearchConfig)}
    kw = {k: v for k, v in vars(args).items() if k in fields}
    for tup in ("crop_size", "batch_size", "num_epochs"):
        if tup in kw and kw[tup] is not None:
            kw[tup] = tuple(kw[tup])
    return SearchConfig(**kw)


def _genotype(arch: str):
    """A released architecture's name, or a genotype literal."""
    from segtpu_torch.models import ARCHS, TEMPLATE_ARCHS
    if arch in ARCHS:
        return ARCHS[arch]
    if arch in TEMPLATE_ARCHS:
        return TEMPLATE_ARCHS[arch]
    return ast.literal_eval(arch)


def _model(args, genotype, device):
    """The segmenter to infer or evaluate with: ``--ckpt`` (a torch
    checkpoint, or for ``eval`` a ``run_training`` ``.npz``), else weights
    from a ``torch.Generator`` seeded 0."""
    import torch
    from segtpu_torch.models import create_segmenter
    if args.ckpt and args.ckpt.endswith(".npz"):
        from segtpu_torch.train import load_trained
        return load_trained(args.ckpt, genotype, args.num_classes,
                            device=device)
    if args.ckpt:
        from segtpu_torch.convert.torch_import import \
            load_segmenter_checkpoint
        return load_segmenter_checkpoint(args.ckpt, genotype,
                                         args.num_classes, device=device)
    return create_segmenter(genotype, args.num_classes, device=device,
                            generator=torch.Generator().manual_seed(0))


def _search_devices(device: str, n: int):
    """``n`` devices of ``--device``'s kind: ``n`` logical CPU devices
    for a CPU, else None (every CUDA device, the mesh's default)."""
    from segtpu_torch.utils.helpers import resolve_device
    dev = resolve_device(device)
    return [dev] * n if dev.type == "cpu" else None


def cmd_search(args):
    cfg = _cfg_from_args(args)
    if getattr(args, "supernet", 0):
        from segtpu_torch.supernet import run_supernet_search
        mesh = None
        if getattr(args, "pop_devices", 0):
            from segtpu_torch.parallel.mesh import make_mesh
            mesh = make_mesh(args.pop_devices, 1, devices=_search_devices(
                args.device, args.pop_devices))
        saver = run_supernet_search(cfg, population=args.supernet,
                                    mesh=mesh, device=args.device)
    elif getattr(args, "fleet", False):
        from segtpu_torch.parallel.fleet import run_fleet_search
        saver = run_fleet_search(cfg, devices=_search_devices(args.device, 1))
    else:
        from segtpu_torch.search import run_search
        saver = run_search(cfg, device=args.device)
    best = saver.best(1)
    if best:
        print(f"best reward {best[0]['reward']:.4f}: {best[0]['genotype']}")


def cmd_infer(args):
    import numpy as np
    from segtpu_torch.data.datasets import _read_image
    from segtpu_torch.engine import Segmenter

    model = _model(args, _genotype(args.arch), "cpu")
    seg = Segmenter(model, device=args.device)
    mask = seg.predict(_read_image(args.image))
    out = args.output or (args.image.rsplit(".", 1)[0] + "_mask.npy")
    np.save(out, mask)
    print(f"wrote {out}: classes {sorted(np.unique(mask).tolist())}")


def cmd_train(args):
    from segtpu_torch.data.datasets import (BatchLoader, SegmentationDataset,
                                            SyntheticDataset)
    from segtpu_torch.train import TrainConfig, run_training

    genotype = _genotype(args.arch)
    if args.synthetic or not args.train_list:
        ds = SyntheticDataset(n=32, hw=tuple(args.crop_size),
                              num_classes=args.num_classes)
        val_ds = ds
    else:
        ds = SegmentationDataset(args.data_root, args.train_list)
        val_ds = SegmentationDataset(args.data_root,
                                     args.val_list or args.train_list)
    cfg = TrainConfig(num_classes=args.num_classes,
                      crop_size=tuple(args.crop_size),
                      shorter_side=args.shorter_side,
                      batch_size=args.batch_size,
                      num_epochs=args.num_epochs,
                      enc_lr=args.enc_lr, dec_lr=args.dec_lr,
                      snapshot_dir=args.snapshot_dir,
                      data_parallel=args.data_parallel,
                      val_every=args.val_every)
    train_loader = BatchLoader(ds, batch_size=cfg.batch_size,
                               crop=cfg.crop_size, train=True,
                               shorter_side=cfg.shorter_side)
    val_loader = BatchLoader(val_ds, batch_size=cfg.batch_size,
                             crop=cfg.crop_size, train=False)
    best, _ = run_training(genotype, train_loader, val_loader, cfg,
                           device=args.device)
    print(f"best val mIoU: {best:.4f} (checkpoint in {cfg.snapshot_dir})")


def cmd_eval(args):
    import numpy as np
    from segtpu_torch.data.datasets import BatchLoader, SegmentationDataset
    from segtpu_torch.engine.trainer import make_eval_step
    from segtpu_torch.utils.metrics import compute_iu, mean_iou

    genotype = _genotype(args.arch)
    model = _model(args, genotype, args.device)
    params = {n: p.detach() for n, p in model.named_parameters()}
    stats = dict(model.named_buffers())
    ds = SegmentationDataset(args.data_root, args.val_list)
    loader = BatchLoader(ds, batch_size=args.batch_size,
                         crop=tuple(args.crop_size), train=False)
    ev = make_eval_step(genotype, num_classes=args.num_classes)
    cm = np.zeros((args.num_classes, args.num_classes), np.int64)
    for batch in loader:
        cm += ev(params, stats, batch).cpu().numpy()
    iu = compute_iu(cm)
    print("per-class IoU:", np.round(iu, 4).tolist())
    print(f"mIoU: {mean_iou(cm):.4f}")


def cmd_fidelity(args):
    """Per-pixel logit fidelity against golden ``.npz`` files holding
    ``image`` (uint8 HWC) and ``logits`` (f32 [H, W, K], the reference's
    full-resolution logits for that image): the f32 engine's logits
    (bilinear, cropped), their worst |difference| and argmax agreement
    per file; exit 1 above ``--max-dlogit``."""
    import numpy as np
    import torch
    from segtpu_torch.engine import Segmenter

    seg = Segmenter(_model(args, _genotype(args.arch), "cpu"),
                    compute_dtype=torch.float32, device=args.device)
    worst = 0.0
    for path in args.golden:
        g = np.load(path)
        img, want = g["image"], g["logits"]
        got = np.transpose(seg.predict(img, return_logits=True), (1, 2, 0))
        err = np.abs(got - want).max()
        agree = (got.argmax(-1) == want.argmax(-1)).mean()
        worst = max(worst, float(err))
        print(f"{path}: max|dlogit|={err:.5f} argmax-agreement={agree:.6f}")
    print(f"worst max|dlogit|: {worst:.5f}")
    if args.max_dlogit is not None and worst > args.max_dlogit:
        print(f"FAIL: worst {worst:.5f} > --max-dlogit {args.max_dlogit}")
        raise SystemExit(1)


def cmd_bench(args):
    from segtpu_torch import bench
    # BENCH_ARCH, where set, wins over --arch, as in the JAX package
    bench.main(["--device", args.device,
                "--arch", os.environ.get("BENCH_ARCH", args.arch)])


def main(argv=None):
    # before cuBLAS first runs: the search's deterministic algorithms
    # need this workspace (utils.helpers.deterministic)
    from segtpu_torch.utils.helpers import CUBLAS_WORKSPACE
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    # the kernels build once per machine, where the knobs say
    from segtpu_torch.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    ap = argparse.ArgumentParser("segtpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("search", help="run the NAS search loop")
    _add_search_flags(ps)
    _add_device_flag(ps)
    ps.set_defaults(fn=cmd_search, do_polyak=True, aux_cell=True)

    pi = sub.add_parser("infer", help="segment one image")
    pi.add_argument("--arch", default="arch0")
    pi.add_argument("--image", required=True)
    pi.add_argument("--num-classes", type=int, default=19)
    pi.add_argument("--ckpt", default="")
    pi.add_argument("--output", default="")
    _add_device_flag(pi)
    pi.set_defaults(fn=cmd_infer)

    pt = sub.add_parser("train", help="train a fixed architecture")
    pt.add_argument("--arch", default="arch0",
                    help="arch0/1/2, template0 or a genotype literal")
    pt.add_argument("--data-root", default="")
    pt.add_argument("--train-list", default="")
    pt.add_argument("--val-list", default="")
    pt.add_argument("--synthetic", action="store_true")
    pt.add_argument("--num-classes", type=int, default=21)
    pt.add_argument("--crop-size", type=int, nargs=2, default=[512, 512])
    pt.add_argument("--shorter-side", type=int, default=512)
    pt.add_argument("--batch-size", type=int, default=16)
    pt.add_argument("--num-epochs", type=int, default=100)
    pt.add_argument("--enc-lr", type=float, default=1e-3)
    pt.add_argument("--dec-lr", type=float, default=3e-3)
    pt.add_argument("--val-every", type=int, default=5)
    pt.add_argument("--snapshot-dir", default="snapshots/train")
    pt.add_argument("--data-parallel", action="store_true")
    _add_device_flag(pt)
    pt.set_defaults(fn=cmd_train)

    pe = sub.add_parser("eval", help="mIoU over a .lst manifest")
    pe.add_argument("--arch", default="arch0")
    pe.add_argument("--data-root", required=True)
    pe.add_argument("--val-list", required=True)
    pe.add_argument("--num-classes", type=int, default=19)
    pe.add_argument("--batch-size", type=int, default=4)
    pe.add_argument("--crop-size", type=int, nargs=2, default=[512, 512])
    pe.add_argument("--ckpt", default="")
    _add_device_flag(pe)
    pe.set_defaults(fn=cmd_eval)

    pb = sub.add_parser("bench", help="headline throughput benchmark")
    pb.add_argument("--arch", default="arch0")
    _add_device_flag(pb)
    pb.set_defaults(fn=cmd_bench)

    pf = sub.add_parser("fidelity",
                        help="per-pixel logit check vs golden .npz files")
    pf.add_argument("--arch", default="arch0")
    pf.add_argument("--num-classes", type=int, default=19)
    pf.add_argument("--ckpt", default="")
    pf.add_argument("--golden", nargs="+", required=True)
    pf.add_argument("--max-dlogit", type=float, default=None,
                    help="exit 1 if worst max|dlogit| exceeds this")
    _add_device_flag(pf)
    pf.set_defaults(fn=cmd_fidelity)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
