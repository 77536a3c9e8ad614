"""Typed configuration of the port's entry points (counterpart of
``topk_rec_tpu/config.py``): the same dataclasses, fields and defaults,
which mirror the reference's (train.py:3-36 and each model's constructor).
The CLI reads its defaults from here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class DataConfig:
    data_dir: str = "data"
    fold: int = 0
    uid_file: str = "uid"
    iid_file: str = "vid"
    content_file: Optional[str] = None  # e.g. meta.pkl

    @property
    def train_file(self) -> str:
        return f"f{self.fold}tr.txt"


@dataclass
class ModelConfig:
    model: str = "bpr"          # bpr | vbpr | wmf | cer | dpm
    k: int = 50
    d: int = 20000              # content feature dim (vbpr/cer/dpm)
    # pairwise models (ref bpr.py:20 / vbpr.py:18)
    lambda_u: float = 2.5e-3
    lambda_i: float = 2.5e-3
    lambda_j: float = 2.5e-4
    lambda_b: float = 0.0
    lambda_e: float = 0.0
    lr: float = 1.0e-4
    mode: str = "l2"
    # ALS models (ref wmf.py:11 / cer.py:17 / dpm.py:11)
    als_lu: float = 0.01
    als_lv: float = 10.0
    als_le: float = 10e3
    als_a: float = 1.0
    als_b: float = 0.01
    seed: int = 0
    # negative-membership store for the pairwise samplers:
    # auto | bitmap | sorted (ops/sampling.py TripletSampler)
    membership: str = "auto"


@dataclass
class TrainConfig:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    out_dir: str = "embed"
    epochs: int = 5
    batch_size: int = 256
    epoch_sample_limit: Optional[int] = None
    max_iter: int = 200         # ALS models
    tol: float = 1e-4
    warm_start: Optional[str] = None
    encoder: str = "mlp"        # mlp | sdae (DPM content encoder)
    encoder_hidden: List[int] = field(default_factory=lambda: [2000, 1000])
    log_dir: Optional[str] = None      # state.log / settings.txt (ALS)
    profile_dir: Optional[str] = None  # profiler trace destination
    save_lag: Optional[int] = None     # %04d-U/V.dat checkpoint cadence
    theta_init: Optional[str] = None   # item-prior matrix file (cr --theta_init)
    ckpt_dir: Optional[str] = None     # native crash-resume checkpoints
    ckpt_every: int = 1                # epochs between native checkpoints
    exchange: str = "gspmd"            # distributed BPR comms: gspmd | explicit


@dataclass
class EvalConfig:
    data_dir: str = "data"
    model_dir: str = "model"
    fold: int = 0
    step: int = 5
    total: int = 30
    scenarios: List[str] = field(default_factory=lambda: ["im", "om"])
    user_chunk: int = 8192
