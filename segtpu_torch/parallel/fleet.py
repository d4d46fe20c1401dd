"""Fleet search: the genotypes of a round proxy-trained at once, one
genotype a device (counterpart: segtpu/parallel/fleet.py).

Each sampled genotype is a different network, so a round cannot be one
program over the population without the masked supernet. The fleet
places one genotype on each device instead: a thread per device runs
``search.proxy_train`` under ``torch.cuda.device(dev)`` on a CUDA
stream of its own (a device listed twice gets two workers and two
streams), and the controller takes one batched policy update a round
from the K (actions, reward) pairs (``rl.agent.train_agent_batch``).

Every device gets a replica of the encoder and of both tap caches.
Each worker has its own loaders, so the stage-2 batches a genotype sees
do not depend on how the threads interleave: worker i's reward equals
``proxy_train`` run alone on fresh loaders with the same genotype and
seed (``cfg.seed + rnd * K + i``). On CPU devices (the tests) the
workers run as threads without streams.
"""

from __future__ import annotations

import contextlib
import copy
import logging
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import torch

from segtpu_torch.config import SearchConfig
from segtpu_torch.models.micro_decoders import GenotypeError
from segtpu_torch.parallel.collectives import per_device
from segtpu_torch.utils.helpers import deterministic
from segtpu_torch.utils.saver import SearchSaver

log = logging.getLogger("segtpu_torch.fleet")


def _on(dev: torch.device, stream):
    """The worker's device and stream (nothing to enter on a CPU)."""
    if dev.type != "cuda":
        return contextlib.nullcontext()
    ctx = contextlib.ExitStack()
    ctx.enter_context(torch.cuda.device(dev))
    ctx.enter_context(torch.cuda.stream(stream))
    return ctx


def _replica(batches, dev):
    return [{k: ([t.to(dev) for t in v] if isinstance(v, list) else v.to(dev))
             for k, v in b.items()} for b in batches]


@deterministic()
def run_fleet_search(cfg: SearchConfig, *, devices: Optional[List] = None,
                     dataset=None, encoder=None):
    """Round-based fleet search, under deterministic algorithms as
    ``search.run_search``: each round samples one genotype a
    device, proxy-trains them concurrently (an invalid genotype scores
    ``cfg.invalid_reward``), then makes one batched controller update.
    ``cfg.num_iters`` counts rounds (K = len(devices) genotypes each).
    ``devices`` defaults to every CUDA device and may repeat one (logical
    workers on one card). Records carry ``miou1``, ``miou2``, ``status``,
    ``round``, ``device`` (the worker's index), ``baseline`` and
    ``seconds`` (the round's). Returns the ``SearchSaver``."""
    from segtpu_torch import search as S
    from segtpu_torch.rl.agent import sample_genotype, train_agent_batch
    from segtpu_torch.utils.helpers import resolve_device

    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())] or ["cuda"]
    devices = [resolve_device(d) for d in devices]
    k = len(devices)
    dev0 = devices[0]
    dataset, encoder, loaders = S.search_setup(cfg, dataset, encoder, dev0)
    log.info("staging encoder + feature cache on %d devices", k)
    cached_train = S._cache_taps(encoder, loaders["cache_train"])
    cached_val = S._cache_taps(encoder, loaders["cache_val"])
    replicas = per_device(devices, lambda d: (
        encoder if d == dev0 else copy.deepcopy(encoder).to(d),
        _replica(cached_train, d), _replica(cached_val, d)))
    # each worker's own stage-2 loaders (a loader's epoch count moves its
    # augmentation) and CUDA stream
    workers = [(S.search_loaders(cfg, dataset),
                torch.cuda.Stream(d) if d.type == "cuda" else None)
               for d in devices]
    agent = S.create_search_agent(cfg, dev0)
    saver = SearchSaver(cfg.snapshot_dir)

    def work(i, genotype, seed):
        dev, (enc, c_train, c_val) = devices[i], replicas[i]
        worker_loaders, stream = workers[i]
        with _on(dev, stream):
            try:
                m1, m2 = S.proxy_train(
                    genotype, enc, cfg, c_train, c_val,
                    worker_loaders["train"], worker_loaders["val"],
                    rng_seed=seed)
                out = S.compute_reward(m1, m2), m1, m2, "ok"
            except GenotypeError as e:
                out = cfg.invalid_reward, 0.0, 0.0, f"invalid: {e}"
            if stream is not None:
                stream.synchronize()
        return out

    with ThreadPoolExecutor(max_workers=k) as pool:
        for rnd in range(cfg.num_iters):
            t0 = time.perf_counter()
            draws = [sample_genotype(agent, torch.Generator(device=dev0)
                                     .manual_seed(S._seed(cfg.seed, 2, rnd,
                                                          i)))
                     for i in range(k)]
            results = list(pool.map(
                work, range(k), [d[0] for d in draws],
                [cfg.seed + rnd * k + i for i in range(k)]))
            rewards = [r[0] for r in results]
            agent = train_agent_batch(
                agent, torch.stack([d[1] for d in draws]), rewards,
                old_logprobs_batch=torch.stack([d[2] for d in draws]))
            seconds = round(time.perf_counter() - t0, 3)
            for i, (r, m1, m2, status) in enumerate(results):
                saver.record(rnd * k + i, draws[i][0], r,
                             {"miou1": m1, "miou2": m2, "status": status,
                              "round": rnd, "device": i,
                              "baseline": float(agent.state.baseline),
                              "seconds": seconds})
            log.info("round %d: %d archs in %.1fs, rewards %s", rnd, k,
                     seconds, [round(float(r), 4) for r in rewards])
            saver.save((rnd + 1) * k, agent.state.params,
                       float(agent.state.baseline))
    return saver
