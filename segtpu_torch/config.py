"""Typed search configuration (counterpart: segtpu/config.py).

The JAX package's ``SearchConfig`` field for field, with its defaults:
one dataclass whose field names follow the reference's flag names, so a
configuration translates 1:1 between the packages and the CLI.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class SearchConfig:
    # --- data (reference: data dirs/lists, crop, num-classes) ---
    data_root: str = ""
    train_list: str = ""               # .lst manifest
    val_list: str = ""
    num_classes: int = 21
    crop_size: Tuple[int, int] = (64, 64)     # reference --crop-size
    shorter_side: Optional[int] = None        # scale-jitter base
    meta_train_prct: float = 0.9              # --meta-train-prct
    synthetic: bool = False                   # test/dev stand-in data

    # --- proxy training, two stages (per-stage lists in the reference) ---
    batch_size: Tuple[int, int] = (8, 8)      # --batch-size per stage
    num_epochs: Tuple[int, int] = (5, 1)      # --num-epochs per stage
    enc_lr: float = 1e-3
    dec_lr: float = 3e-3
    enc_wd: float = 1e-5
    dec_wd: float = 0.0
    enc_grad_clip: float = 3.0                # --enc-grad-clip
    dec_grad_clip: float = 3.0                # --dec-grad-clip
    dec_aux_weight: float = 0.15              # --dec-aux-weight
    aux_cell: bool = True                     # auxiliary cells (CVPR'19)
    do_kd: bool = False                       # --do-kd
    kd_coeff: float = 0.3                     # --kd-coeff
    do_polyak: bool = True                    # --do-polyak
    cache_encoder_feats: bool = True          # CVPR'19 stage-1 speed trick
    agg_size: int = 48
    sep_repeats: int = 1                      # --sep-repeats

    # --- controller (reference: rl flags) ---
    ctrl_version: str = "cvpr"                # --ctrl-version cvpr | wacv
    ctrl_algo: str = "ppo"                    # 'reinforce' | 'ppo'
    ctrl_lr: float = 1e-4                     # --ctrl-lr
    ctrl_baseline_decay: float = 0.95         # --ctrl-baseline-decay
    ctrl_entropy_coef: float = 1e-4
    lstm_hidden_size: int = 100               # --lstm-hidden-size
    op_size: int = 100                        # --op-size (embedding dim)
    num_blocks: int = 3
    num_cell_nodes: int = 3

    # --- search loop ---
    num_iters: int = 100
    seed: int = 42
    snapshot_dir: str = "snapshots"           # --snapshot-dir
    resume: bool = False
    val_every: int = 1                        # --val-every
    invalid_reward: float = 0.0               # reward for failed builds

    # --- encoder weights ---
    enc_ckpt: str = ""  # torch MobileNet-v2 checkpoint -> convert.torch_import
