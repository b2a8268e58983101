"""ImageNet ResNet trainer — counterpart of ``examples/imagenet/main_amp.py``.

The same recipe as the JAX trainer (the reference's amp + FusedSGD + DDP +
SyncBN ImageNet example): the ResNet forward with BN running stats threaded
as uncast model state (``amp.initialize(..., has_state=True)``), the images
normalized on the device inside the step, the scaled loss's gradients
unscaled with the overflow flag (K5), and FusedSGD (K10), which skips the
step on overflow. At O2/O5 the params live in per-dtype arenas
(``arena_native``): one K10 pass per arena updates the fp32 masters and the
momentum in place and writes the fp16 (O2) or bf16 (O5) model arena the
forward reads. At O0, O1, O3 and O4 the list path packs the parameter,
gradient and momentum trees into arenas and unpacks them every step, as the
JAX trainer's ``FusedSGD.step`` does: fp32 params at O0/O1/O4 (O1 and O4
cast them to fp16 or bf16 at every forward, BN kept fp32, and run the model
in the autocast scope), fp16 params with fp32 momentum at O3, one K10 pass
a dtype bucket. O1 and O2 scale the loss dynamically from 2^16 unless
``loss_scale`` says otherwise. The step reads nothing back to the host: its
metrics stay on the device.

Data parallel (``distributed``): one process per rank, in a
``torch.distributed`` world the caller initializes (NCCL on the card; gloo
on the CPU). Where the JAX trainer runs the step inside ``shard_map`` over a
``("data",)`` mesh, here every rank runs it on its slice of the global
batch (:meth:`Trainer.shard_batch` cuts it as the mesh shards it) with
``DistributedDataParallel``'s reduction of the still-scaled gradients
before K5 (``bucket_bytes``, ``compress``), or its backward-time hooks
(``overlap_backward``); the metrics are averaged across ranks, and the BN
state too when BN is not synchronized (``sync_bn`` makes every BN a SyncBN
over the data axis). A distributed trainer without an initialized process
group raises.

``fused_optimizer`` swaps in another fused optimizer (FusedAdagrad on K17,
FusedNovoGrad on K18, FusedLARS on K10 after its trust ratios) and
``use_larc`` wraps the optimizer in LARC, as in the JAX trainer. None of
those has a flat step, so they keep the list path at every level (at O5
over tree-shaped fp32 masters).

Precision at O0: the convolutions are cuDNN's in fp32 tensors, and cuDNN
runs fp32 convolutions in TF32 while ``torch.backends.cudnn.allow_tf32`` is
True (PyTorch's default). This module leaves that global as the caller set
it.

``--profile-dir DIR`` writes a ``torch.profiler`` trace of the first epoch
into DIR (``monitor.spans.trace``); ``--flight-recorder PATH`` keeps a ring
of the printed steps' metrics (``monitor.FlightRecorder``), dumped to PATH
on a crash and at the end of the run.

Run (one process, or one a rank under ``torchrun --nproc_per_node=N``,
whose ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` ``main`` reads; without
them it trains a world of one)::

    python -m beforeholiday_tpu_torch.examples.imagenet.main_amp -a resnet50 \\
        -b 128 --opt-level O5 --iters 50
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from beforeholiday_tpu_torch import amp
from beforeholiday_tpu_torch.models import resnet
from beforeholiday_tpu_torch.monitor import FlightRecorder, comms
from beforeholiday_tpu_torch.monitor.spans import trace as profile_trace
from beforeholiday_tpu_torch.ops._dispatch import resolve_device
from beforeholiday_tpu_torch.ops.arena import tree_flatten, tree_unflatten
from beforeholiday_tpu_torch.optimizers import FusedSGD, supports_flat_step
from beforeholiday_tpu_torch.parallel import DistributedDataParallel, LARC
from beforeholiday_tpu_torch.parallel.parallel_state import DATA_AXIS, get_group

# ImageNet channel stats, in 0-255 space like the reference prefetcher
_MEAN = np.array([0.485, 0.456, 0.406], np.float32) * 255.0
_STD = np.array([0.229, 0.224, 0.225], np.float32) * 255.0


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy over the batch, in fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[:, None].long()).mean()


def topk_accuracy(logits, labels, ks=(1, 5)):
    """Prec@k in percent, as device tensors."""
    k = min(max(ks), logits.shape[-1])
    top = torch.topk(logits.float(), k, dim=-1).indices
    hit = top == labels[:, None]
    return {f"prec{q}": 100.0 * hit[:, :min(q, k)].any(dim=1).float().mean()
            for q in ks}


@dataclasses.dataclass
class Trainer:
    """The step functions and the current training state."""

    cfg: resnet.ResNetConfig
    amp_model: Any
    train_step: Callable  # (state..., images, labels, lr) -> (state..., metrics)
    eval_step: Callable
    params: Any
    opt_state: Any
    scaler_state: Any
    bn_state: Any
    distributed: bool
    global_batch: int
    device: torch.device
    rank: int = 0
    world: int = 1

    def step(self, images, labels, lr):
        """One training step on device tensors; returns the metrics dict
        (device tensors: nothing is read back)."""
        (self.params, self.opt_state, self.scaler_state, self.bn_state, metrics) = (
            self.train_step(self.params, self.opt_state, self.scaler_state,
                            self.bn_state, images, labels, lr))
        return metrics

    def evaluate(self, images, labels):
        return self.eval_step(self.params, self.bn_state, images, labels)

    def shard_batch(self, images, labels):
        """This rank's slice of a global batch (NHWC uint8 images, int
        labels; numpy arrays or tensors) on the device: rows ``[rank * b,
        (rank + 1) * b)``, ``b = global_batch / world``, as the JAX
        trainer's mesh shards the batch over ``data``."""
        b = len(labels) // self.world
        rows = slice(self.rank * b, (self.rank + 1) * b)
        images, labels = images[rows], labels[rows]
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(np.ascontiguousarray(images))
            labels = torch.from_numpy(np.asarray(labels))
        return images.to(self.device), labels.long().to(self.device)


def build_trainer(
    arch: str = "resnet50",
    *,
    opt_level: str = "O0",
    lr: float = 0.1,
    momentum: float = 0.9,
    weight_decay: float = 1e-4,
    loss_scale: Optional[Any] = None,
    keep_batchnorm_fp32: Optional[bool] = None,
    sync_bn: bool = False,
    use_larc: bool = False,
    global_batch: int = 128,
    num_classes: int = 1000,
    distributed: Optional[bool] = None,
    seed: int = 0,
    cfg: Optional[resnet.ResNetConfig] = None,
    fused_optimizer: Optional[Any] = None,
    bucket_bytes: Optional[int] = None,
    compress: bool = False,
    overlap_backward: bool = False,
    params: Any = None,
    bn_state: Any = None,
    device=None,
    impl: Optional[str] = None,
) -> Trainer:
    """Model, amp and optimizer, in the reference's setup order: model, the
    learning rate scaled by ``global_batch / 256``, FusedSGD (or
    ``fused_optimizer``), LARC around it with ``use_larc``,
    ``amp.initialize``. LARC refuses an inner decay, so ``use_larc`` raises
    ``ValueError`` unless ``weight_decay`` is 0, as in the JAX trainer.

    ``params`` and ``bn_state`` (both or neither) start the trainer from
    given weights, for example the JAX model's through
    ``resnet.params_from_numpy``/``state_from_numpy``; otherwise
    ``resnet.init`` draws them from ``seed``. ``device``: ``cuda`` unless
    the caller asks for another one. ``impl="torch"`` puts the unscale and
    the optimizer on their plain versions (the card-side yardstick); None
    runs the kernels on CUDA tensors.

    ``distributed`` (default: a ``torch.distributed`` world of more than
    one rank is initialized) trains data-parallel over the data axis's
    group, each rank on its ``global_batch / world`` slice; ``sync_bn``,
    ``bucket_bytes``, ``compress`` and ``overlap_backward`` are DDP's and
    SyncBN's (the module docstring). Every rank must draw the same initial
    weights (the same ``seed``, or the same ``params``)."""
    if (params is None) != (bn_state is None):
        raise ValueError("pass both params and bn_state, or neither")
    if distributed is None:
        distributed = dist.is_initialized() and dist.get_world_size() > 1
    rank, world = 0, 1
    if distributed:
        if not dist.is_initialized():
            raise RuntimeError(
                "distributed=True needs an initialized torch.distributed "
                "process group (dist.init_process_group)")
        group = get_group(DATA_AXIS)
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        if global_batch % world != 0:
            raise ValueError(f"global batch {global_batch} not divisible by "
                             f"{world} ranks")
    device = resolve_device(device)
    if cfg is None:
        cfg = resnet.CONFIGS[arch](num_classes=num_classes)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        params, bn_state = resnet.init(cfg, gen, device=device)

    # "Scale learning rate based on global batch size"
    lr = lr * float(global_batch) / 256.0
    opt = fused_optimizer or FusedSGD(lr, momentum, weight_decay=weight_decay,
                                      impl=impl)
    if use_larc:
        opt = LARC(opt)

    bn_axis = DATA_AXIS if (sync_bn and distributed) else None

    def apply_train(p, bn, images):
        return resnet.forward(p, bn, images, cfg, training=True,
                              axis_name=bn_axis)

    def apply_eval(p, bn, images):
        return resnet.forward(p, bn, images, cfg, training=False)

    # O2/O5 take the arena-native path (fp32 masters and momentum flat,
    # grads born flat, the master-to-model cast fused into K10); an
    # optimizer without a flat step keeps the list path
    arena_native = opt_level in ("O2", "O5") and supports_flat_step(opt)
    amp_model = amp.initialize(
        apply_train, params, opt, opt_level,
        keep_batchnorm_fp32=keep_batchnorm_fp32, loss_scale=loss_scale,
        has_state=True, arena_native=arena_native,
    )
    eval_apply = amp.make_apply(amp_model.policy, apply_eval, has_state=True)
    optimizer, scaler = amp_model.optimizer, amp_model.scaler
    mean = torch.from_numpy(_MEAN).to(device)
    std = torch.from_numpy(_STD).to(device)
    ddp = (DistributedDataParallel(bucket_bytes=bucket_bytes, compress=compress,
                                   overlap_backward=overlap_backward)
           if distributed else None)

    def normalize(images):
        # the reference prefetcher's sub_(mean).div_(std), inside the step
        return (images.float() - mean) / std

    def loss_fn(p, x, labels, bn):
        if ddp is not None and ddp.overlap_backward:
            # the backward-time reduction: each bucket's all-reduce is
            # issued inside the backward as its gradients land
            p = ddp.hook(p)
        logits, new_bn = amp_model.apply(p, bn, x)
        return softmax_cross_entropy(logits, labels), (new_bn, logits)

    svag = amp.scaled_value_and_grad(
        loss_fn, scaler, has_aux=True, impl=impl,
        reduce_grads=(ddp.reduce if ddp is not None and not ddp.overlap_backward
                      else None))

    def pmean_metrics(metrics):
        # the metrics averaged across ranks, in one collective (the JAX
        # trainer's pmean); found_inf is the same on every rank already
        keys = [k for k in metrics if k != "found_inf"]
        stacked = torch.stack([metrics[k].float() for k in keys])
        avg = comms.psum(stacked, DATA_AXIS, site="trainer.metrics",
                         inplace=True) / world
        return {**metrics, **dict(zip(keys, avg.unbind(0)))}

    def train_step(params, opt_state, scaler_state, bn_state, images, labels, lr):
        # BN's running stats advance even on a step the optimizer skips
        loss, (new_bn, logits), grads, found_inf, new_scaler_state = svag(
            params, scaler_state, normalize(images), labels, bn_state)
        new_params, new_opt_state = optimizer.step(
            params, grads, opt_state, found_inf=found_inf, lr=lr)
        metrics = {"loss": loss, "found_inf": found_inf,
                   "scale": new_scaler_state["scale"],
                   **topk_accuracy(logits, labels)}
        if ddp is not None:
            metrics = pmean_metrics(metrics)
            if bn_axis is None:
                # unsynchronized BN keeps per-rank statistics; the trainer
                # keeps one copy, their average across ranks, as JAX does
                leaves, treedef = tree_flatten(new_bn)
                summed = comms.psum(leaves, DATA_AXIS, site="trainer.bn_state")
                new_bn = tree_unflatten(treedef, [t / world for t in summed])
        return new_params, new_opt_state, new_scaler_state, new_bn, metrics

    @torch.no_grad()
    def eval_step(params, bn_state, images, labels):
        logits, _ = eval_apply(params, bn_state, normalize(images))
        m = {"loss": softmax_cross_entropy(logits, labels),
             **topk_accuracy(logits, labels)}
        return pmean_metrics(m) if ddp is not None else m

    return Trainer(
        cfg=cfg, amp_model=amp_model, train_step=train_step,
        eval_step=eval_step, params=amp_model.params,
        opt_state=optimizer.init(amp_model.params),
        scaler_state=scaler.init(device=device), bn_state=bn_state,
        distributed=bool(distributed), global_batch=global_batch, device=device,
        rank=rank, world=world,
    )


def adjust_learning_rate(base_lr, epoch, step, steps_per_epoch):
    """Warmup over 5 epochs, then /10 at epochs 30, 60 and 80."""
    factor = 0 if epoch < 30 else 1 if epoch < 60 else 2 if epoch < 80 else 3
    lr = base_lr * (0.1**factor)
    if epoch < 5:
        lr = lr * float(1 + step + epoch * steps_per_epoch) / (5.0 * steps_per_epoch)
    return lr


def synthetic_batches(global_batch, image_size, num_classes, n, seed=1234):
    """uint8 NHWC image batches and labels, standing in for the ImageFolder
    loader (the same numpy stream as the JAX trainer's)."""
    rng = np.random.RandomState(seed)
    for _ in range(n):
        yield (
            rng.randint(0, 256, (global_batch, image_size, image_size, 3), np.uint8),
            rng.randint(0, num_classes, (global_batch,), np.int64),
        )


def train(trainer: Trainer, *, iters: int, image_size: int = 224,
          base_lr: float = 0.1, print_freq: int = 10, epoch: int = 0,
          flight=None):
    """One synthetic 'epoch' of ``iters`` steps; prints reference-style
    lines, reading the metrics back only on the lines it prints. Returns the
    best images/s of the printed intervals. ``flight`` (a
    ``monitor.FlightRecorder``) records each printed row."""
    num_classes = trainer.cfg.num_classes
    it = synthetic_batches(trainer.global_batch, image_size, num_classes, iters)
    scaled_lr = base_lr * trainer.global_batch / 256.0
    t_end = time.perf_counter()
    speeds = []
    last_print = 0
    for i, (images, labels) in enumerate(it):
        lr = adjust_learning_rate(scaled_lr, epoch, i, iters)
        images, labels = trainer.shard_batch(images, labels)
        metrics = trainer.step(images, labels, lr)
        if (i + 1) % print_freq == 0 or i == iters - 1:
            metrics = {k: float(v) for k, v in metrics.items()}  # host sync
            n_steps = (i + 1) - last_print
            last_print = i + 1
            dt = (time.perf_counter() - t_end) / n_steps
            t_end = time.perf_counter()
            speed = trainer.global_batch / dt
            speeds.append(speed)
            print(
                f"Epoch: [{epoch}][{i + 1}/{iters}]  Speed {speed:.1f} img/s  "
                f"Loss {metrics['loss']:.4f}  Prec@1 {metrics['prec1']:.2f}  "
                f"Prec@5 {metrics['prec5']:.2f}  scale {metrics['scale']:.0f}"
            )
            if flight is not None:
                # only the rows the print cadence already read back: the
                # recorder adds no readback of its own
                flight.record(epoch * iters + i + 1, metrics)
    return max(speeds) if speeds else 0.0


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ImageNet training (synthetic data)")
    p.add_argument("--arch", "-a", default="resnet50", choices=sorted(resnet.CONFIGS))
    p.add_argument("--batch-size", "-b", type=int, default=128,
                   help="GLOBAL batch size (the reference's is per-process)")
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", "--wd", type=float, default=1e-4)
    p.add_argument("--opt-level", default="O0",
                   choices=["O0", "O1", "O2", "O3", "O4", "O5"])
    p.add_argument("--keep-batchnorm-fp32", default=None,
                   type=lambda s: {"True": True, "False": False}[s])
    p.add_argument("--loss-scale", default=None,
                   type=lambda s: s if s == "dynamic" else float(s))
    p.add_argument("--sync_bn", action="store_true", help="SyncBN over the data axis")
    p.add_argument("--larc", action="store_true")
    p.add_argument("--iters", type=int, default=50, help="steps per epoch (synthetic)")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--print-freq", "-p", type=int, default=10)
    p.add_argument("--deterministic", action="store_true")
    p.add_argument("--profile-dir", default=None,
                   help="write a profiler trace of one epoch here")
    p.add_argument("--flight-recorder", default=None, metavar="PATH",
                   help="keep a ring buffer of recent step metrics and dump "
                        "it to PATH on crash or exit")
    p.add_argument("--bucket-bytes", type=int, default=None,
                   help="coalesce gradient all-reduces into buckets of this "
                        "many bytes")
    p.add_argument("--compress", action="store_true",
                   help="all-reduce gradients in bf16 with fp32 accumulation")
    p.add_argument("--overlap-backward", action="store_true",
                   help="issue each bucket's all-reduce inside the backward")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain "
                        "versions of the kernels)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    print(f"opt_level = {args.opt_level}")
    print(f"keep_batchnorm_fp32 = {args.keep_batchnorm_fp32}")
    print(f"loss_scale = {args.loss_scale}")
    seed = 0 if args.deterministic else int(time.time()) % (2**31)
    launched = "WORLD_SIZE" in os.environ  # torchrun sets RANK, WORLD_SIZE, ...
    if launched:
        device = torch.device(args.device or "cuda")
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
        # every rank starts from rank 0's weights
        box = [seed]
        dist.broadcast_object_list(box, src=0)
        seed = box[0]
        args.device = device
    trainer = build_trainer(
        args.arch, opt_level=args.opt_level, lr=args.lr, momentum=args.momentum,
        weight_decay=args.weight_decay, loss_scale=args.loss_scale,
        keep_batchnorm_fp32=args.keep_batchnorm_fp32, sync_bn=args.sync_bn,
        use_larc=args.larc, global_batch=args.batch_size,
        num_classes=args.num_classes, seed=seed,
        bucket_bytes=args.bucket_bytes, compress=args.compress,
        overlap_backward=args.overlap_backward, device=args.device,
    )
    print(f"device: {trainer.device}  distributed: {trainer.distributed}  "
          f"rank {trainer.rank} of {trainer.world}")
    # the context manager arms a crash dump (an uncaught exception dumps the
    # ring to PATH) and dumps on an exception leaving the block
    flight = (FlightRecorder(path=args.flight_recorder)
              if args.flight_recorder else None)
    best = 0.0
    try:
        with flight if flight is not None else contextlib.nullcontext():
            for epoch in range(args.epochs):
                # one epoch (the first) traced, as the flag promises
                with profile_trace(args.profile_dir if epoch == 0 else None):
                    best = max(best, train(
                        trainer, iters=args.iters, image_size=args.image_size,
                        base_lr=args.lr, print_freq=args.print_freq,
                        epoch=epoch, flight=flight,
                    ))
        if flight is not None:
            # a clean run still writes the ring: the flag always leaves the
            # file it promised
            flight.dump(reason="run_end")
    finally:
        if launched:
            dist.destroy_process_group()
    print(f"peak speed: {best:.1f} img/s")
    return best


if __name__ == "__main__":
    main()
