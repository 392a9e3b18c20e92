"""Training runtime (counterpart of ``mri_inr_tpu/train/trainer.py``): one
train step and an epoch loop with the same artifacts.

Per batch: crop the 24x24 centre target from the fully-sampled patch ->
model(undersampled patch) -> criterion -> optimizer step. Initial train/val
loss before training; validation every epoch; every ``save_interval`` epochs
a checkpoint and train/val snapshot renders; a progress log with epoch, loss
and wall-clock columns; a final checkpoint at the end.

In PyTorch's idiom:

- the train step is eager: ``loss.backward()`` and ``optimizer.step()`` on a
  :class:`TrainState` (model, optimizer, step) that is updated in place;
- with ``use_pallas`` (the config key's name) the forward and backward of the
  modulator + SIREN chain are the fused kernels of
  ``ops/siren_train_kernel.py`` (CUDA on the card, plain versions on the
  CPU); otherwise, and for residual models, the module path under autograd;
- validation and snapshots go through ``make_apply_fn``, so they run the
  fused eval forward when training runs fused, with the same sine degree;
- parameters stay f32; with ``precision: bf16`` the encoder and modulator
  compute in bf16 (the model's ``compute_dtype``) and the chain multiplies
  bf16 inputs into f32 sums;
- each step's dropout is the JAX package's, from ``fold_in(key(base
  seed), step)``, so a resumed run continues the same stream. The fused
  path takes the integer in [0, 2^23) its chain draws from that key
  (:func:`step_seed`) and the counter hash of it
  (``ops/siren_train_kernel.py:dropout_mask``); the module path draws
  Flax's masks: each hidden layer's ``nn.Dropout`` key
  (:func:`epoch_dropout_keys`) and ``bernoulli`` per element
  (``ops/dropout.py``, a CUDA kernel on the card), set on each
  ``SirenLayer`` as ``dropout_mask_fn``;
- ``device_data`` keeps each dataset's tiles on the device and runs each
  epoch through :func:`make_scan_epoch`, the counterpart of the JAX
  package's one-dispatch ``lax.scan`` epoch: every batch is gathered on the
  device from the epoch's index matrix (:func:`make_epoch_perm`), and on the
  card the epoch is one CUDA graph, captured once and replayed once per
  epoch. A dataset with ``materialize`` (the online k-space set) hands over
  its device tiles each epoch; one with ``fully_tiles`` is uploaded once;
- spans (``utils/profiling.span``: host seconds and entries, and a
  ``torch.profiler`` range while one records) name an epoch's host work:
  ``mri.epoch.train`` / ``mri.epoch.val`` around each epoch's loss,
  ``mri.train.post_epoch`` (``mri.train.checkpoint`` inside),
  ``mri.epoch.perm``, ``mri.epoch.fetch`` (the loss read back) and
  ``mri.train.invalidate_packs``; in :class:`ScanEpoch` ``mri.epoch.call``
  (its ``launch_seconds``) around ``mri.epoch.seeds``, ``mri.epoch.stage``
  and ``mri.epoch.warm`` / ``capture`` / ``replay`` on the card or
  ``mri.epoch.run`` (the plain loop). No span lies inside the body a graph
  captures.

Data parallelism (the counterpart of the JAX package's ``shard_map`` step
over a ``data`` mesh): given a process group, every rank takes its
contiguous ``B / N`` rows of each global batch (``parallel/mesh.py``), runs
the same forward and backward on them and averages loss and gradients over
the ranks in one all-reduce of one flat buffer a step (``lax.pmean``) before
the same optimizer step on every rank. On the fused path each rank drops
with its own stream (:func:`step_seed` with the rank folded in, as the mesh
step folds in the device's axis index); on the module path, where the JAX
package keeps GSPMD and one global mask, each rank draws its rows of that
mask (the same keys, at an offset of ``rank * B / N`` rows). Only the
primary rank writes checkpoints, snapshots, the progress log and the
TensorBoard scalars (``tensorboard=True``: ``training_loss`` and
``validation_loss`` per epoch under ``run_dir/tensorboard``); every rank
passes a barrier after a checkpoint.
"""

from __future__ import annotations

import csv
import functools
import math
import pathlib
import signal
import time
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from mri_inr_tpu_torch.data.dataset import epoch_index_batches
from mri_inr_tpu_torch.eval.evaluate import SliceReconstructor
from mri_inr_tpu_torch.models import flax_init
from mri_inr_tpu_torch.ops import dropout as drop_ops
from mri_inr_tpu_torch.ops import siren_kernel as sk
from mri_inr_tpu_torch.ops import siren_train_kernel as stk
from mri_inr_tpu_torch.ops import tiling
from mri_inr_tpu_torch.ops.siren_kernel import make_apply_fn
from mri_inr_tpu_torch.parallel import distributed, mesh
from mri_inr_tpu_torch.train import checkpoint as ckpt_lib
from mri_inr_tpu_torch.utils import jax_random
from mri_inr_tpu_torch.utils import tensorboard as tb_lib
from mri_inr_tpu_torch.utils import visualization
from mri_inr_tpu_torch.utils.device import module_device, resolve_device
from mri_inr_tpu_torch.utils.profiling import span


@dataclass
class TrainState:
    """What a checkpoint holds; updated in place by the train step."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_optimizer(name: str, lr: float, params) -> torch.optim.Optimizer:
    """``adam`` (b1 0.9, b2 0.999, eps 1e-8: optax's defaults) or ``sgd``.
    For parameters on the card Adam is ``fused`` (one kernel a step) and
    ``capturable``: its step count is a device tensor, so a CUDA graph
    replays its update. Torch refuses both flags for CPU parameters."""
    params = list(params)
    if name == "adam":
        card = any(p.is_cuda for p in params)
        return torch.optim.Adam(params, lr=lr, capturable=card, fused=card or None)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr)
    raise ValueError(f"Unknown optimizer {name!r}")


def create_train_state(model: nn.Module, optimizer: str, lr: float) -> TrainState:
    return TrainState(model, make_optimizer(optimizer, lr, model.parameters()), 0)


def splice_pretrained_encoder(model: nn.Module, autoencoder_state: dict) -> nn.Module:
    """Install pretrained autoencoder weights into the model's latent
    encoder; they are then fine-tuned jointly with the SIREN. A conv
    autoencoder's state dict carries an ``encoder.`` subtree, which replaces
    the ``custom`` encoder; a VGG autoencoder's carries a ``trunk.``
    subtree, which replaces the ``vgg`` encoder's conv stack and leaves its
    latent head (``fc``) as initialised. Loads are strict."""
    enc = model.encoder.encoder
    if any(k.startswith("trunk.") for k in autoencoder_state):
        if not hasattr(enc, "trunk"):
            raise ValueError("a VGG autoencoder's trunk needs model.encoder_type=vgg")
        sub, target = "trunk.", enc.trunk
    else:
        sub, target = "encoder.", enc
    state = {k[len(sub):]: v for k, v in autoencoder_state.items() if k.startswith(sub)}
    if not state:
        raise ValueError("the state dict has no 'encoder.' or 'trunk.' subtree")
    target.load_state_dict(state, strict=True)
    return model


def _freeze_encoder_grads(model: nn.Module) -> None:
    """Zero the latent encoder's conv-stack gradients
    (``training.freeze_encoder``): it stays at its loaded initialisation
    while the modulator and the SIREN train. For the ``vgg`` encoder only
    the trunk is frozen and its latent head (``fc``) trains, as in the JAX
    package."""
    enc = model.encoder.encoder
    for p in getattr(enc, "trunk", enc).parameters():
        if p.grad is not None:
            p.grad.zero_()


def epoch_seeds(base_seed: int, step0: int, num_batches: int,
                rank: int | None = None) -> np.ndarray:
    """The dropout seeds of train steps ``step0 .. step0 + num_batches - 1``
    as the (num_batches,) float32 array an epoch's seed buffer holds (every
    seed is below 2^23, so exact). Step ``s`` draws the JAX package's fused
    seed ``randint(k, (1,), 0, 2**23)`` (``mri_inr_tpu/ops/
    siren_train_kernel.py:678``) of ``k = fold_in(key(base_seed), s)``
    (``mri_inr_tpu/train/trainer.py:171,208,328``), and where ``rank`` is
    given of ``fold_in(k, rank)``: the mesh step's ``fold_in(dropout_rng,
    axis_index("data"))`` (``:186-188``)."""
    keys = jax_random.fold_in(jax_random.key(base_seed),
                              np.arange(step0, step0 + num_batches))
    if rank is not None:
        keys = jax_random.fold_in(keys, rank)
    return jax_random.randint(keys, (), 0, 2**23).astype(np.float32)


def step_seed(base_seed: int, step: int, rank: int | None = None) -> int:
    """The dropout seed of train step ``step`` (:func:`epoch_seeds`)."""
    return int(epoch_seeds(base_seed, step, 1, rank)[0])


def epoch_dropout_keys(base_seed: int, step0: int, num_batches: int, model) -> np.ndarray:
    """The module path's dropout keys of train steps ``step0 .. step0 +
    num_batches - 1``: ``(num_batches, L, 2)`` uint32, one key per step and
    dropping layer. Step ``s`` applies the model under ``rngs={"dropout":
    fold_in(key(base_seed), s)}`` (``mri_inr_tpu/train/trainer.py:
    171,208,328``), and hidden layer ``i`` draws under that key folded as
    its ``nn.Dropout`` (:func:`~mri_inr_tpu_torch.models.flax_init.
    dropout_keys`). No rank is folded in: the JAX module path's mesh step
    is GSPMD, one global mask."""
    steps = jax_random.fold_in(jax_random.key(base_seed),
                               np.arange(step0, step0 + num_batches))
    return flax_init.dropout_keys(model, steps)


#: steps whose seeds the per-step route draws at once: on the host, one
#: step's seed drawn alone costs about as much as 256 drawn together
#: (``scripts/torch_step_seed_ab.py``)
SEED_BLOCK = 256


def _mean_over_ranks(model, loss: torch.Tensor, group) -> torch.Tensor:
    """The step's ``pmean``: the gradients and the loss, flattened into one
    buffer, averaged over the ranks by one all-reduce and written back;
    returns the mean loss."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads] + [loss.detach().float().reshape(1)])
    distributed.all_reduce_mean_(flat, group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset : offset + g.numel()].view_as(g))
        offset += g.numel()
    return flat[-1]


def _fused(model, use_pallas: bool) -> bool:
    return bool(use_pallas) and not getattr(model, "residual", False)


def _rank_mask(keys: torch.Tensor, keep: float, rank: int, shape: tuple) -> torch.Tensor:
    """This rank's rows of the global keep mask: ``shape`` is the local
    batch's, rank ``r`` starts ``r`` local batches into the global one."""
    return drop_ops.threefry_keep_mask(keys, shape, keep, offset=rank * math.prod(shape))


def _make_step_body(model, loss_fn, outer: int, siren: int, *, fused: bool, sin5: bool,
                    freeze_encoder: bool, group=None):
    """``body(state, fully, under, drop) -> loss``: one optimizer step on
    ``state``, ``state.step`` left alone. ``drop`` is the step's dropout: on
    the fused path its seed (an int or a (1,) float32 tensor holding one),
    on the module path its (L, 2) int32 keys (:func:`epoch_dropout_keys`)
    on the batch's device. With a ``group`` of more than one rank the batch
    is this rank's rows, and loss and gradients are averaged over the ranks
    before the optimizer step."""
    hidden_layers = [] if fused else [layer for layer, _ in flax_init.dropout_layers(model)]
    rank, _ = distributed.rank_world(group)

    def forward(under: torch.Tensor, drop) -> torch.Tensor:
        if fused:
            return stk.fused_train_apply(model, under, drop, sin5=sin5)
        # module path: hidden layer i keeps Flax's bernoulli mask of its key
        # drop[i], read on the device, so no host RNG runs and the step can
        # be captured
        for i, layer in enumerate(hidden_layers):
            layer.dropout_mask_fn = functools.partial(_rank_mask, drop[i],
                                                      1.0 - layer.dropout, rank)
        model.train()
        try:
            return model(under)
        finally:
            model.eval()
            for layer in hidden_layers:
                layer.dropout_mask_fn = None

    def body(state: TrainState, fully: torch.Tensor, under: torch.Tensor, drop) -> torch.Tensor:
        target = tiling.extract_center_batch(fully, outer, siren).float()
        state.optimizer.zero_grad(set_to_none=True)
        pred = forward(under, drop)
        loss = loss_fn(pred.float(), target)
        loss.backward()
        if freeze_encoder:
            _freeze_encoder_grads(model)
        if group is not None:
            loss = _mean_over_ranks(model, loss, group)
        state.optimizer.step()
        return loss.detach()

    return body


def make_train_step(model, loss_fn, outer: int, siren: int, *, use_pallas: bool = False,
                    sin5: bool = False, freeze_encoder: bool = False, group=None):
    """Build ``step(state, fully, under, base_seed) -> loss`` (a 0-d tensor
    on the batch's device, detached). ``state`` is updated in place. With a
    process ``group`` of N > 1 ranks (the counterpart of the JAX package's
    ``mesh=``) every rank passes the same global batch, steps on its
    :func:`~mri_inr_tpu_torch.parallel.mesh.local_rows` with its rank's
    dropout, and returns the loss averaged over the ranks.

    The dropout is that of the JAX train CLI's per-step route, which always
    steps under a mesh (``train_mod_siren.py``): its fused step folds the
    device's axis index into every step's key, on one device too
    (``mri_inr_tpu/train/trainer.py:186-188,201``), and over ranks the port
    folds the rank in; its module step does not (``:208``), and the port's
    ranks draw their rows of one global mask (:func:`epoch_dropout_keys`)."""
    rank, world = distributed.rank_world(group)
    fused = _fused(model, use_pallas)
    body = _make_step_body(model, loss_fn, outer, siren, fused=fused,
                           sin5=sin5, freeze_encoder=freeze_encoder,
                           group=group if world > 1 else None)
    block: dict = {}  # the dropout of the SEED_BLOCK steps around the last step

    def drop_of(base_seed: int, s: int, device: torch.device):
        start = s - s % SEED_BLOCK
        if block.get("key") != (base_seed, start, device):
            if fused:
                drops = epoch_seeds(base_seed, start, SEED_BLOCK, rank)
            else:  # the block's keys on the device: one copy every SEED_BLOCK steps
                drops = drop_ops.keys_tensor(
                    epoch_dropout_keys(base_seed, start, SEED_BLOCK, model), device)
            block.update(key=(base_seed, start, device), drops=drops)
        drop = block["drops"][s - start]
        return int(drop) if fused else drop

    def step(state: TrainState, fully: torch.Tensor, under: torch.Tensor,
             base_seed: int) -> torch.Tensor:
        if world > 1:
            fully, under = (mesh.local_rows(t, rank, world) for t in (fully, under))
        loss = body(state, fully, under, drop_of(base_seed, state.step, under.device))
        state.step += 1
        return loss

    return step


def make_eval_step(model, loss_fn, outer: int, siren: int, *, use_pallas: bool = False,
                   sin5: bool = False, device: str | torch.device | None = None,
                   group=None):
    """Build ``eval_step(state, fully, under) -> loss`` through
    :func:`make_apply_fn`: the fused eval forward when training runs fused,
    with ``sin5`` following the trainer's choice. Dropout is off. With a
    ``group`` of N > 1 ranks each rank scores its rows of the global batch
    and the loss is the mean of the ranks' losses."""
    apply_fn = make_apply_fn(model, use_pallas=use_pallas, sin5=sin5, device=device)
    rank, world = distributed.rank_world(group)

    @torch.no_grad()
    def eval_step(state: TrainState, fully: torch.Tensor, under: torch.Tensor):
        if world > 1:
            fully, under = (mesh.local_rows(t, rank, world) for t in (fully, under))
        target = tiling.extract_center_batch(fully, outer, siren).float()
        loss = loss_fn(apply_fn(under).float(), target)
        if world > 1:
            loss = distributed.all_reduce_mean_(loss.reshape(1), group)[0]
        return loss

    eval_step.apply_fn = apply_fn
    return eval_step


def make_epoch_perm(n: int, batch_size: int, seed: int, shuffle: bool) -> np.ndarray:
    """(num_batches, batch_size) int32 index matrix with the batch
    composition of ``MRIDataset.batches`` (shuffled order, remainder wrapped
    from the epoch's start): shared by the host loop and the device-resident
    epoch."""
    return np.stack(epoch_index_batches(n, batch_size, seed, shuffle)).astype(np.int32)


def _launch_counters() -> tuple:
    """The kernel wrappers whose ``launches`` a graph replay must advance."""
    return (stk.siren_chain_train_fwd_cuda, stk.siren_chain_train_bwd_cuda,
            sk.siren_forward_cuda, sk.siren_forward_int8_cuda, drop_ops.threefry_keep_mask_cuda)


@dataclass
class _Buffers:
    """An epoch's two inputs: the permutation and the dropout draws (the
    fused path's seeds, or the module path's keys), in static device tensors
    a graph reads, staged through pinned host memory."""

    host_perm: torch.Tensor
    host_seeds: torch.Tensor
    perm: torch.Tensor
    seeds: torch.Tensor
    copied: torch.cuda.Event | None = None


@dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    loss: torch.Tensor  # the mean loss each replay writes
    launches: tuple  # kernel launches one replay makes, per _launch_counters()
    fingerprint: tuple  # the parameters' and the optimizer state's storage


class ScanEpoch:
    """``epoch(state, fully_all, under_all, perm, base_seed, train) -> loss``:
    one epoch over device-resident tiles, the counterpart of the JAX
    package's ``make_scan_epoch``. ``perm`` is the epoch's (num_batches,
    batch) index matrix (:func:`make_epoch_perm`); the result is the mean
    loss, a 0-d tensor (on the card a graph's output: read it before the next
    epoch). A train epoch steps the optimizer once a batch and advances
    ``state.step`` by ``num_batches``; step ``i`` of the epoch draws its
    dropout from ``seeds[i]`` of :func:`epoch_seeds` on the fused path, from
    the keys ``[i]`` of :func:`epoch_dropout_keys` on the module path.

    On the card the epoch is one CUDA graph per (tiles, shape, train flag),
    on the fused path and on the module path (``use_pallas: false``, residual
    models) alike: both draw their dropout from the epoch's device buffer of
    seeds or keys. The first epoch of each runs eagerly on a side stream: it
    is the warm-up torch's capture recipe asks for (Adam's state, the kernel
    libraries and their function attributes, cuBLAS), and a real epoch. The
    second is captured, which runs nothing, and then replayed, like every
    later one: the host copies the permutation and the seeds or keys into the
    graph's static buffers, replays, and the caller reads one loss. The
    eval graph repacks the kernel weights from the parameters inside the
    graph, once an epoch. A capture or a replay that fails raises.

    The kernel wrappers count launches in Python, which a replay does not
    run: a capture takes back what it counted, and each replay adds the
    launches the graph holds. A replay updates the parameters without
    moving their ``_version`` (fused Adam does not move it either): a
    caller that keeps a
    :class:`~mri_inr_tpu_torch.ops.siren_kernel.WeightPack` invalidates it
    after a train epoch (``Trainer.invalidate_packs``). A change of the
    optimizer's state tensors (``restore_state``'s ``load_state_dict``)
    drops the graphs; the next epoch runs eagerly again. The tiles are read
    by address: a caller that hands over new tiles each epoch writes them
    into the same tensors (``OnlineKspaceDataset.materialize``) on the
    stream the replay runs on.

    On the CPU every epoch runs the same body as a plain loop over the same
    buffers. So does every epoch of a data-parallel run (a ``group`` of N >
    1 ranks), on the card too, since a collective under gloo cannot be
    captured into a CUDA graph: each rank steps on its columns of ``perm``
    with its rank's seeds, averages loss and gradients between steps, and
    an eval epoch's loss is averaged over the ranks at its end."""

    def __init__(self, model, loss_fn, outer: int, siren: int, *, use_pallas: bool = False,
                 sin5: bool = False, freeze_encoder: bool = False, group=None):
        self.model, self.loss_fn, self.outer, self.siren = model, loss_fn, outer, siren
        self.fused = _fused(model, use_pallas)
        self.group = group
        self.rank, self.world = distributed.rank_world(group)
        self._train_body = _make_step_body(model, loss_fn, outer, siren, fused=self.fused,
                                           sin5=sin5, freeze_encoder=freeze_encoder,
                                           group=group if self.world > 1 else None)
        self._eval_apply = make_apply_fn(model, use_pallas=use_pallas, sin5=sin5,
                                         device=module_device(model))
        self._buffers: dict = {}
        self._graphs: dict = {}
        self._warm: set = set()
        self.captures = self.replays = 0
        self.launch_seconds = 0.0  # host time of the last epoch up to its replay's return

    # ------------------------------------------------------------------
    def _stage(self, key, device: torch.device, perm: np.ndarray, seeds: np.ndarray):
        bufs = self._buffers.get(key)
        if bufs is None:
            pin = device.type == "cuda"
            hp = torch.empty(perm.shape, dtype=torch.int64, pin_memory=pin)
            hs = torch.empty(seeds.shape, dtype=torch.from_numpy(seeds).dtype, pin_memory=pin)
            bufs = self._buffers[key] = _Buffers(
                hp, hs, torch.empty_like(hp, device=device), torch.empty_like(hs, device=device))
        if bufs.copied is not None:  # the last epoch's copies have left the pinned memory
            bufs.copied.synchronize()
        bufs.host_perm.copy_(torch.from_numpy(perm))
        bufs.host_seeds.copy_(torch.from_numpy(seeds))
        bufs.perm.copy_(bufs.host_perm, non_blocking=True)
        bufs.seeds.copy_(bufs.host_seeds, non_blocking=True)
        if device.type == "cuda":
            bufs.copied = torch.cuda.Event()
            bufs.copied.record()
        return bufs

    def _run(self, state, fully_all, under_all, bufs: _Buffers, train: bool) -> torch.Tensor:
        """The epoch's body: the loop a graph captures."""
        losses = []
        packed = None
        if not train and self.fused:
            packed = sk.pack_weights(self.model)
        for i in range(bufs.perm.shape[0]):
            idx = bufs.perm[i]
            fully = fully_all.index_select(0, idx)
            under = under_all.index_select(0, idx)
            if train:
                drop = bufs.seeds[i : i + 1] if self.fused else bufs.seeds[i]
                losses.append(self._train_body(state, fully, under, drop))
                continue
            with torch.no_grad():
                target = tiling.extract_center_batch(fully, self.outer, self.siren).float()
                pred = (self._eval_apply.forward(under, packed) if self.fused
                        else self._eval_apply(under))
                losses.append(self.loss_fn(pred.float(), target))
        return torch.stack(losses).mean()

    @staticmethod
    def _fingerprint(state) -> tuple:
        opt = [v.data_ptr() for st in state.optimizer.state.values() for v in st.values()
               if isinstance(v, torch.Tensor)]
        return (id(state.optimizer), *(p.data_ptr() for p in state.model.parameters()), *opt)

    def _capture(self, key, state, fully_all, under_all, bufs, train, fingerprint) -> _Graph:
        if torch.is_anomaly_enabled():
            raise ValueError(
                "anomaly detection (training.debug_nans) cannot be captured into the CUDA "
                "graph of a device-resident epoch (training.device_data)")
        counters = _launch_counters()
        before = [k.launches for k in counters]
        graph = torch.cuda.CUDAGraph()
        if train:  # the graph's steps allocate their gradients from its pool
            state.optimizer.zero_grad(set_to_none=True)
        with torch.cuda.graph(graph):
            loss = self._run(state, fully_all, under_all, bufs, train)
        launches = tuple(k.launches - b for k, b in zip(counters, before))
        for k, n in zip(counters, launches):  # recorded, not run
            k.launches -= n
        self.captures += 1
        entry = self._graphs[key] = _Graph(graph, loss, launches, fingerprint)
        return entry

    def _graphed(self, key, state, fully_all, under_all, bufs, train) -> torch.Tensor:
        fingerprint = self._fingerprint(state)
        entry = self._graphs.get(key)
        if entry is not None and entry.fingerprint != fingerprint:
            self._graphs.clear()
            self._warm.clear()
            entry = None
        if entry is None and key not in self._warm:
            with span("mri.epoch.warm"):
                side = torch.cuda.Stream(fully_all.device)
                side.wait_stream(torch.cuda.current_stream(fully_all.device))
                with torch.cuda.stream(side):
                    loss = self._run(state, fully_all, under_all, bufs, train)
                torch.cuda.current_stream(fully_all.device).wait_stream(side)
            self._warm.add(key)
            return loss
        if entry is None:
            with span("mri.epoch.capture"):
                entry = self._capture(key, state, fully_all, under_all, bufs, train,
                                      fingerprint)
        with span("mri.epoch.replay"):
            entry.graph.replay()
        for k, n in zip(_launch_counters(), entry.launches):
            k.launches += n
        self.replays += 1
        return entry.loss

    def __call__(self, state, fully_all: torch.Tensor, under_all: torch.Tensor,
                 perm: np.ndarray, base_seed: int, train: bool) -> torch.Tensor:
        with span("mri.epoch.call") as call:
            loss = self._call(state, fully_all, under_all, perm, base_seed, train)
        self.launch_seconds = call.seconds
        return loss

    def _call(self, state, fully_all, under_all, perm, base_seed, train) -> torch.Tensor:
        device = fully_all.device
        nb = perm.shape[0]
        # one process: the JAX scan epoch's dropout (its trainer.py:328);
        # over ranks the mesh step's, which the JAX package runs there instead
        with span("mri.epoch.seeds"):
            if not train:
                seeds = np.zeros(nb, np.float32)
            elif self.fused:
                seeds = epoch_seeds(base_seed, state.step, nb,
                                    self.rank if self.world > 1 else None)
            else:
                seeds = epoch_dropout_keys(base_seed, state.step, nb, self.model).view(np.int32)
        if self.world > 1:  # this rank's rows of every global batch
            perm = np.ascontiguousarray(mesh.local_rows(perm.T, self.rank, self.world).T)
        key = (fully_all.data_ptr(), under_all.data_ptr(), tuple(fully_all.shape),
               tuple(perm.shape), train)
        with span("mri.epoch.stage"):
            bufs = self._stage(key, device, perm, seeds)
        if device.type == "cuda" and self.world == 1:
            loss = self._graphed(key, state, fully_all, under_all, bufs, train)
        else:
            with span("mri.epoch.run"):
                loss = self._run(state, fully_all, under_all, bufs, train)
                if self.world > 1 and not train:
                    loss = distributed.all_reduce_mean_(loss.reshape(1), self.group)[0]
        if train:
            state.step += nb
        return loss


def make_scan_epoch(model, loss_fn, outer: int, siren: int, *, use_pallas: bool = False,
                    sin5: bool = False, freeze_encoder: bool = False,
                    group=None) -> ScanEpoch:
    """The one-dispatch epoch over device-resident tiles (counterpart of the
    JAX package's ``make_scan_epoch``): see :class:`ScanEpoch`."""
    return ScanEpoch(model, loss_fn, outer, siren, use_pallas=use_pallas, sin5=sin5,
                     freeze_encoder=freeze_encoder, group=group)


class Trainer:
    """Epoch loop + artifacts (checkpoints, snapshots, progress log, and with
    ``tensorboard`` the scalars ``training_loss`` and ``validation_loss``
    per epoch in ``run_dir/tensorboard``). With a process ``group`` of N > 1
    ranks every rank trains on its rows of each global batch and only the
    primary writes artifacts."""

    def __init__(self, model, state: TrainState, loss_fn, train_dataset, val_dataset,
                 run_dir: str | pathlib.Path, batch_size: int = 400,
                 save_interval: int = 100, snapshot_slices: int = 2,
                 outer_patch_size: int = 32, siren_patch_size: int = 24,
                 base_seed: int = 0, log=print, tensorboard: bool = False,
                 use_pallas: bool = False, device_data: bool = False, sin5: bool = False,
                 freeze_encoder: bool = False,
                 device: str | torch.device | None = None, group=None):
        self.device = resolve_device(device)
        if module_device(model) != self.device:
            raise ValueError(f"model is on {module_device(model)}, not on {self.device}")
        self.model = model
        self.state = state
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        self.run_dir = pathlib.Path(run_dir)
        self.batch_size = batch_size
        self.save_interval = save_interval
        self.snapshot_slices = snapshot_slices
        self.base_seed = base_seed
        self.log = log
        self.outer = outer_patch_size
        self.siren = siren_patch_size
        self.device_data = device_data
        rank, world = distributed.rank_world(group)
        mesh.check_divisible(batch_size, world)
        self.primary = rank == 0
        if world > 1:
            log(f"data-parallel over {world} ranks: every epoch runs step by step, the "
                "gradient all-reduce between the steps (a gloo collective cannot be "
                "captured into a CUDA graph)")

        self.train_step = make_train_step(
            model, loss_fn, outer_patch_size, siren_patch_size, use_pallas=use_pallas,
            sin5=sin5, freeze_encoder=freeze_encoder, group=group)
        self.eval_step = make_eval_step(
            model, loss_fn, outer_patch_size, siren_patch_size, use_pallas=use_pallas,
            sin5=sin5, device=self.device, group=group)
        self.scan_epoch = make_scan_epoch(
            model, loss_fn, outer_patch_size, siren_patch_size, use_pallas=use_pallas,
            sin5=sin5, freeze_encoder=freeze_encoder, group=group) if device_data else None
        self._dev_tiles: dict = {}
        # snapshot rendering shares the fused eval path when training fused
        self.reconstructor = SliceReconstructor(
            make_apply_fn(model, use_pallas=use_pallas, sin5=sin5, device=self.device),
            outer_patch_size=outer_patch_size,
            inner_patch_size=getattr(model, "inner_patch_size", 16),
            siren_patch_size=siren_patch_size, device=self.device)
        self.initial_losses: tuple[float, float] | None = None
        self._progress: list[dict] = []
        self._start_time = time.time()
        self._said_per_step = self._said_no_plots = False
        self._tb = None
        if self.primary:
            (self.run_dir / "snapshots").mkdir(parents=True, exist_ok=True)
            if tensorboard:
                self._tb = tb_lib.summary_writer(self.run_dir / "tensorboard")

    # ------------------------------------------------------------------
    def _run_batch(self, fully: torch.Tensor, under: torch.Tensor, train: bool):
        if train:
            return self.train_step(self.state, fully, under, self.base_seed)
        return self.eval_step(self.state, fully, under)

    def _epoch_loss(self, dataset, train: bool, epoch: int) -> float:
        if self.device_data and (hasattr(dataset, "materialize")
                                 or hasattr(dataset, "fully_tiles")):
            loss = self._scan_epoch_loss(dataset, train, epoch)
        else:
            if self.device_data and not self._said_per_step:
                self.log(f"device_data: {type(dataset).__name__} holds no tiles to keep on "
                         "the device; its epochs run step by step from host batches")
                self._said_per_step = True
            losses = []
            for fully, under in dataset.batches(self.batch_size, seed=epoch, shuffle=train,
                                                prefetch=2):
                fully = torch.from_numpy(fully).to(self.device)
                under = torch.from_numpy(under).to(self.device)
                losses.append(self._run_batch(fully, under, train))
            with span("mri.epoch.fetch"):
                loss = float(torch.stack(losses).mean())
        if train:
            with span("mri.train.invalidate_packs"):
                self.invalidate_packs()
        return loss

    def _scan_epoch_loss(self, dataset, train: bool, epoch: int) -> float:
        """An epoch over device-resident tiles through :func:`make_scan_epoch`:
        a dataset with ``materialize`` gives this epoch's device tiles (the
        same tensors every epoch, rewritten per mask epoch), one with
        ``fully_tiles`` is uploaded once; batches in the host loop's
        composition (:func:`make_epoch_perm`), one host synchronisation."""
        if hasattr(dataset, "materialize"):
            fully_all, under_all = dataset.materialize(epoch)
            if fully_all.device != self.device:
                raise ValueError(f"{type(dataset).__name__} lives on {fully_all.device}, "
                                 f"the trainer on {self.device}")
        else:
            key = id(dataset)
            if key not in self._dev_tiles:
                self._dev_tiles[key] = (
                    torch.from_numpy(dataset.fully_tiles).to(self.device),
                    torch.from_numpy(dataset.under_tiles).to(self.device))
            fully_all, under_all = self._dev_tiles[key]
        with span("mri.epoch.perm"):
            perm = make_epoch_perm(len(dataset), self.batch_size, epoch, shuffle=train)
        loss = self.scan_epoch(self.state, fully_all, under_all, perm, self.base_seed, train)
        with span("mri.epoch.fetch"):
            return float(loss)

    def invalidate_packs(self) -> None:
        """Make the validation step and the snapshots repack the kernel
        weights; called after every train epoch, whose updates may have
        moved no parameter's ``_version`` (a CUDA graph's replay; fused
        Adam's kernel)."""
        for apply_fn in (self.eval_step.apply_fn, self.reconstructor.apply_fn):
            if hasattr(apply_fn, "pack"):
                apply_fn.pack.invalidate()

    def initial_errors(self) -> tuple[float, float]:
        """Train and validation loss before training."""
        train_loss = self._epoch_loss(self.train_dataset, train=False, epoch=0)
        val_loss = self._epoch_loss(self.val_dataset, train=False, epoch=0)
        self.log(f"initial losses: train={train_loss:.6f} val={val_loss:.6f}")
        self.initial_losses = (train_loss, val_loss)
        return self.initial_losses

    def train(self, epochs: int, initial_epoch: int = 0) -> TrainState:
        """Epoch loop. A SIGTERM (cluster preemption) finishes the current
        epoch, saves a final checkpoint and the progress log, and returns;
        with ``continue_training`` the next run resumes from there."""
        preempted = []
        try:  # signal handlers only install from the main thread
            prev = signal.signal(signal.SIGTERM, lambda *_: preempted.append(True))
        except ValueError:
            prev = None
        try:
            for epoch in range(initial_epoch, epochs):
                t0 = time.time()
                with span("mri.epoch.train"):
                    train_loss = self._epoch_loss(self.train_dataset, train=True, epoch=epoch)
                with span("mri.epoch.val"):
                    val_loss = self._epoch_loss(self.val_dataset, train=False, epoch=epoch)
                with span("mri.train.post_epoch"):
                    self._post_epoch(epoch, train_loss, val_loss, time.time() - t0)
                # a SIGTERM that reached any rank stops every rank here
                if distributed.any_rank(bool(preempted)):
                    self.log(f"SIGTERM: stopping after epoch {epoch}")
                    break
        finally:
            if prev is not None:
                signal.signal(signal.SIGTERM, prev)
        self._save()
        if self.primary:
            self._write_progress_log()
        if self._tb is not None:
            self._tb.close()
        return self.state

    def _save(self) -> None:
        """The primary writes the checkpoint; every rank waits for it."""
        with span("mri.train.checkpoint"):
            if self.primary:
                ckpt_lib.save_state(self.run_dir, self.state.step, self.state)
            distributed.sync_hosts("checkpoint")

    # ------------------------------------------------------------------
    def _post_epoch(self, epoch: int, train_loss: float, val_loss: float, secs: float):
        self._progress.append({
            "epoch": epoch,
            "train_loss": train_loss,
            "val_loss": val_loss,
            "epoch_seconds": secs,
            "time_since_start": time.time() - self._start_time,
        })
        self.log(f"epoch {epoch}: train={train_loss:.6f} val={val_loss:.6f} ({secs:.2f}s)")
        if self._tb is not None:
            self._tb.add_scalar("training_loss", train_loss, epoch)
            self._tb.add_scalar("validation_loss", val_loss, epoch)
            self._tb.flush()
        if (epoch + 1) % self.save_interval == 0:
            self._save()
            if self.primary:
                self._render_snapshots(epoch)
        if (epoch + 1) % 100 == 0 and self.primary:
            self._write_progress_log()

    def _render_snapshots(self, epoch: int):
        if not visualization.have_matplotlib():
            if not self._said_no_plots:
                self.log("matplotlib is not installed: snapshot renders left out")
                self._said_no_plots = True
            return
        out = self.run_dir / "snapshots"
        for split, dataset in (("train", self.train_dataset), ("val", self.val_dataset)):
            for i in range(self.snapshot_slices):
                pair = dataset.get_slice(i)
                recon, fully, under, _ = self.reconstructor(pair.fully_sampled,
                                                            pair.undersampled)
                visualization.save_image_comparison(
                    [fully.cpu().numpy(), under.cpu().numpy(), recon.cpu().numpy()],
                    ["fully sampled", "undersampled", "reconstruction"],
                    f"{split}_{i}_epoch_{epoch:05d}", out)

    def _write_progress_log(self):
        with open(self.run_dir / "progress_log.csv", "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=[
                "epoch", "train_loss", "val_loss", "epoch_seconds", "time_since_start"])
            writer.writeheader()
            writer.writerows(self._progress)
        # human-readable subsampled view: every 20th epoch
        rows = [r for r in self._progress if r["epoch"] % 20 == 0] or self._progress
        lines = [f"{'epoch':>6} {'train_loss':>12} {'val_loss':>12} {'t_total':>10}"] + [
            f"{r['epoch']:>6} {r['train_loss']:>12.6f} {r['val_loss']:>12.6f} "
            f"{r['time_since_start']:>10.1f}"
            for r in rows
        ]
        (self.run_dir / "progress_log.txt").write_text("\n".join(lines) + "\n")
