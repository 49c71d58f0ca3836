#!/usr/bin/env python
"""Image-classification training on the PyTorch port (``mxnet_tpu_torch``).

The loop of ``example/gluon/image_classification.py`` on the port:
``gluon.data.DataLoader`` -> hybridized model-zoo net -> autograd ->
``Trainer``, with optional AMP (``--amp``: bfloat16 convolutions and
dense layers, float32 BatchNorm and loss). It runs on ``gpu(0)``, or on
the CPU with ``--cpu``. Nothing is downloaded: ``--dataset synthetic``
draws the reference's seeded arrays, and ``mnist``/``cifar10`` read the
files under ``MXNET_HOME`` or draw the reference's synthetic stand-ins
(``MXNET_SYNTHETIC_DATA``, on by default).

Examples:
    python example/gluon/image_classification_torch.py --model resnet18_v1 \
        --dataset synthetic --epochs 1 --batch-size 64
    python example/gluon/image_classification_torch.py --dataset cifar10 \
        --amp --num-workers 4
    python example/gluon/image_classification_torch.py --cpu \
        --model resnet18_v1 --num-batches 2 --batch-size 8
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

import numpy as onp  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="resnet18_v1",
                   help="any mxnet_tpu_torch.gluon.model_zoo.vision name")
    p.add_argument("--dataset", default="synthetic",
                   choices=["synthetic", "mnist", "cifar10"])
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--wd", type=float, default=1e-4)
    p.add_argument("--optimizer", default="sgd")
    p.add_argument("--classes", type=int, default=10)
    p.add_argument("--image-size", type=int, default=32)
    p.add_argument("--num-batches", type=int, default=0,
                   help="synthetic dataset size in batches (0 = 20)")
    p.add_argument("--num-workers", type=int, default=0,
                   help="DataLoader worker processes")
    p.add_argument("--amp", action="store_true", help="bf16 mixed precision")
    p.add_argument("--no-hybridize", action="store_true")
    p.add_argument("--save", default="", help="save .params path")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    return p.parse_args(argv)


def get_data(args):
    """The training and validation loaders (the reference example's
    ``get_data``)."""
    from mxnet_tpu_torch import gluon

    c, h = 3, args.image_size
    if args.dataset == "synthetic":
        n = (args.num_batches or 20) * args.batch_size
        rng = onp.random.RandomState(0)
        X = rng.uniform(0, 1, (n, c, h, h)).astype(onp.float32)
        y = rng.randint(0, args.classes, n).astype(onp.float32)
        ds = gluon.data.ArrayDataset(X, y)
        val = gluon.data.ArrayDataset(X[: 2 * args.batch_size],
                                      y[: 2 * args.batch_size])
    else:
        cls = (gluon.data.vision.MNIST if args.dataset == "mnist"
               else gluon.data.vision.CIFAR10)
        tform = gluon.data.vision.transforms.ToTensor()
        ds = cls(train=True).transform_first(tform)
        val = cls(train=False).transform_first(tform)
    loader = gluon.data.DataLoader(ds, batch_size=args.batch_size,
                                   shuffle=True, last_batch="discard",
                                   num_workers=args.num_workers)
    val_loader = gluon.data.DataLoader(val, batch_size=args.batch_size,
                                       num_workers=args.num_workers)
    return loader, val_loader


def evaluate(net, loader):
    from mxnet_tpu_torch.gluon import metric

    acc = metric.Accuracy()
    for x, y in loader:
        acc.update(y, net(x))
    return acc.get()[1]


def build(args):
    """The net (initialized, hybridized unless ``--no-hybridize``), its
    Trainer and the loss; ``amp.init()`` first with ``--amp``."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.model_zoo import vision

    net = getattr(vision, args.model)(classes=args.classes)
    net.initialize()
    if args.amp:
        from mxnet_tpu_torch import amp

        amp.init()
    if not args.no_hybridize:
        net.hybridize()
    trainer = gluon.Trainer(
        net.collect_params(), args.optimizer,
        {"learning_rate": args.lr, "momentum": args.momentum,
         "wd": args.wd} if args.optimizer in ("sgd", "nag")
        else {"learning_rate": args.lr, "wd": args.wd})
    return net, trainer, gluon.loss.SoftmaxCrossEntropyLoss()


def train_epoch(net, trainer, loss_fn, loader):
    """One epoch: (mean loss, images, seconds)."""
    from mxnet_tpu_torch import autograd

    t0 = time.time()
    total, n = 0.0, 0
    for x, y in loader:
        with autograd.record():
            loss = loss_fn(net(x), y).mean()
        autograd.backward(loss)
        trainer.step(x.shape[0])
        total += float(loss.detach()) * x.shape[0]
        n += x.shape[0]
    return total / max(n, 1), n, time.time() - t0


def main(argv=None):
    args = parse_args(argv)
    import mxnet_tpu_torch as mx

    scope = mx.cpu() if args.cpu else contextlib.nullcontext()
    with scope:
        net, trainer, loss_fn = build(args)
        loader, val_loader = get_data(args)
        try:
            for epoch in range(args.epochs):
                loss, n, secs = train_epoch(net, trainer, loss_fn, loader)
                acc = evaluate(net, val_loader)
                print(f"epoch {epoch}: loss={loss:.4f} val_acc={acc:.4f} "
                      f"throughput={n / secs:.1f} img/s", flush=True)
        finally:
            loader.close()
            val_loader.close()
        if args.save:
            net.save_parameters(args.save)
            print(f"saved {args.save}")


if __name__ == "__main__":
    main()
