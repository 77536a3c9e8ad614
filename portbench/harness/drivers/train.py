"""Training traffic: a closed loop of ``train_chunk`` on the seeded fold.

Set-up makes the fold and the initial tables from the seed and builds the
model (BPR or VBPR as the configuration names it) on them. Its first chunk,
``chunk_steps`` steps at ``batch_size`` through the window's own call,
warms the loop and is the one the check follows: the triplets its sampler
drew (drawn again from the generator's state before the chunk), its summed
loss, and the tables and accumulators it leaves are kept. The same model
then runs the window: chunks as the model's ``train`` runs them, epochs of
``epoch_samples`` samples, each on its own stream, the loss read once an
epoch. It ends at the first chunk boundary after ``--seconds``, with a
synchronisation. After it, ``profile_chunks`` more chunks run under the
profiler: their busy device time per step is ``train_busy_ms_per_step``,
and in a traced run the per-layer metrics read them.

The traffic file's keys: ``batch_size``, ``chunk_steps``,
``epoch_samples``, ``profile_chunks``."""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from .. import checks
from ..fold import make_features, make_fold
from ..opcount import train_flops_per_sample
from ..result import Outcome
from ..seeds import generator
from ..trace import profiled

LEAF_INIT_STD = 0.01  # N(0, 0.01²) factors, as the reference's bpr.py:77-79


def initial_params(cfg: dict, n_users: int, n_items: int, seed: int,
                   device) -> Dict[str, torch.Tensor]:
    """The model's first tables, made from the seed: N(0, 0.01²) factors,
    zero biases, and for VBPR ``cem`` the constant 2/(d·k) and ``icb``
    zero (single/vbpr.py:37-48)."""
    g = generator(seed, "tables", device)
    k = cfg["k"]

    def normal(n, w):
        return LEAF_INIT_STD * torch.randn(n, w, generator=g, device=device)

    if cfg["model"] == "bpr":
        return {"ue": normal(n_users, k), "ie": normal(n_items, k),
                "ib": torch.zeros(n_items, device=device)}
    h, d = k // 2, cfg["d"]
    return {"ure": normal(n_users, h), "uce": normal(n_users, h),
            "ire": normal(n_items, h),
            "irb": torch.zeros(n_items, device=device),
            "cem": torch.full((d, h), 2.0 / (d * k), device=device),
            "icb": torch.zeros(d, device=device)}


def build_model(cfg: dict, inter, init: Dict[str, torch.Tensor], feat,
                device):
    """The program's model on the fold, its tables copies of ``init``."""
    h = checks.hyper(cfg)
    common = dict(lambda_u=h["lu"], lambda_i=h["li"], lambda_j=h["lj"],
                  lambda_b=h["lb"], lr=h["lr"], mode=cfg["mode"],
                  device=device)
    own = {n: t.clone() for n, t in init.items()}
    if cfg["model"] == "bpr":
        from topk_rec_torch.models.bpr import BPR, BPRTables

        model = BPR(k=cfg["k"], table_layout=cfg["table_layout"], **common)
        model.set_interactions(inter)
        model.tables = BPRTables(own["ue"], own["ie"], own["ib"])
        return model
    from topk_rec_torch.models.vbpr import VBPR, VBPRTables

    model = VBPR(k=cfg["k"], d=cfg["d"], lambda_e=h["le"], **common)
    model.set_interactions(inter)
    model.set_features(feat.cpu().numpy())
    model.tables = VBPRTables(own)
    return model


def chunk_call(model, cfg: dict, batch: int) -> Callable:
    """``call(gen, n_steps)``: one ``train_chunk`` as the model's ``train``
    makes it (BPR on the layout its ``auto`` rule picks)."""
    if cfg["model"] == "bpr":
        fused = model.picks_fused(batch)
        return lambda gen, n: model.train_chunk(gen, n, batch, fused)
    return lambda gen, n: model.train_chunk(gen, n, batch)


@dataclass
class Warmup:
    """The first chunk as the program ran it, copied off its state."""
    triplets: Tuple[torch.Tensor, ...]   # (u, i, j), each [steps, batch]
    loss: float                          # the chunk's summed loss
    params: Dict[str, torch.Tensor]      # the tables after the chunk
    ms: Dict[str, torch.Tensor]          # the accumulators after the chunk


def warm_up(model, call: Callable, traffic: dict, seed: int,
            device) -> Warmup:
    """Run the model's first chunk through ``call`` and keep what it did.
    The triplets are the sampler's draw from the generator's state before
    the chunk, drawn again."""
    steps, batch = traffic["chunk_steps"], traffic["batch_size"]
    gen = generator(seed, "steps", device)
    before = gen.get_state()
    loss = float(call(gen, steps))
    gen.set_state(before)
    trip = tuple(t.clone() for t in model.sample_chunk(gen, steps, batch))
    return Warmup(trip, loss,
                  {n: t.detach().clone()
                   for n, t in model.tables.params().items()},
                  {n: t.detach().clone()
                   for n, t in model.tables.ms().items()})


def setup(cfg: dict, traffic: dict, seed: int, device):
    """(fold, initial tables, features or None, model, its chunk call,
    the warm-up chunk)."""
    from topk_rec_torch.data import Interactions

    fold = make_fold(cfg, seed, device)
    inter = Interactions(fold.n_users, fold.n_items,
                         fold.train_u.astype(np.int32),
                         fold.train_i.astype(np.int32))
    init = initial_params(cfg, fold.n_users, fold.n_items, seed, device)
    feat = make_features(cfg, seed, device) if cfg["model"] == "vbpr" else None
    model = build_model(cfg, inter, init, feat, device)
    call = chunk_call(model, cfg, traffic["batch_size"])
    warm = warm_up(model, call, traffic, seed, device)
    return fold, init, feat, model, call, warm


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device, t_start: float) -> Outcome:
    from topk_rec_torch.models.bpr import stream_generator

    on_card = torch.device(device).type == "cuda"
    batch, steps = traffic["batch_size"], traffic["chunk_steps"]
    fold, init, feat, model, call, warm = setup(cfg, traffic, seed, device)
    sync(device)
    per_epoch = -(-(traffic["epoch_samples"] // batch + 1) // steps)

    t0 = time.perf_counter()
    setup_s = t0 - t_start
    if on_card:
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
    chunk_losses, epoch, epoch_losses = [], 0, []
    gen = stream_generator(seed, epoch, device)
    while True:
        epoch_losses.append(call(gen, steps))
        if len(epoch_losses) == per_epoch:
            float(torch.stack(epoch_losses).sum())  # the epoch's loss read
            chunk_losses += epoch_losses
            epoch_losses, epoch = [], epoch + 1
            gen = stream_generator(seed, epoch, device)
        if time.perf_counter() - t0 >= seconds:
            break
    if on_card:
        ev1.record()
    sync(device)
    elapsed = time.perf_counter() - t0
    chunk_losses += epoch_losses
    losses = torch.stack(chunk_losses).cpu()
    n_chunks = losses.numel()
    samples = n_chunks * steps * batch
    rate = samples / elapsed
    event_s = ev0.elapsed_time(ev1) * 1e-3 if on_card else elapsed

    # after the window, in every run: ``profile_chunks`` chunks profiled,
    # the host's operations only in a traced run
    n_prof = traffic["profile_chunks"]
    tr = profiled("train", lambda: [call(gen, steps) for _ in range(n_prof)],
                  device, host_ops=trace)
    tr.counts = {"steps": n_prof * steps}
    tr.window = {"samples_per_s": rate,
                 "s_per_step": event_s / (n_chunks * steps),
                 "flops_per_sample": train_flops_per_sample(cfg, batch),
                 "batch": batch}
    metrics = {"train_samples_per_s": rate, "setup_s": setup_s}
    if tr.device:
        metrics["train_busy_ms_per_step"] = 1e3 * tr.busy_s() / (
            n_prof * steps)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    del model, call
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    found = checks.train(cfg, fold, init, feat, warm, device)
    return Outcome(
        metrics=metrics, attempted=n_chunks,
        failed=int((~torch.isfinite(losses)).sum()),
        checks=found, memory_peak_bytes=peak, trace=tr if trace else None)
