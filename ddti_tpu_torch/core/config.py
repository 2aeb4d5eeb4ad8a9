"""Experiment configuration, ported from ``ddti_tpu/core/config.py``: the
fields the training slice reads (the run lifecycle's among them), with
the JAX package's names and defaults, the YAML model dispatch
(``--config_path``) and the run directories.

Run-directory layout, as in the JAX package and the reference:
``<base_dir>/<ModelType>_<YYYYmmdd_HHMMSS>/{models,log,result}`` with an
Asia/Shanghai timestamp and a ``config.yaml`` snapshot of the resolved
config.
"""

from __future__ import annotations

import dataclasses
import os
from datetime import datetime, timezone
from typing import Optional

try:
    from zoneinfo import ZoneInfo
    _SHANGHAI = ZoneInfo("Asia/Shanghai")
except Exception:  # pragma: no cover - no tz database
    _SHANGHAI = timezone.utc


@dataclasses.dataclass
class Config:
    """The training slice's knobs (field names follow the reference flags;
    ``device`` is the port's own)."""

    # dataset
    dataset_path: str = "data/dataset"
    dataset: str = "DDTI"
    checkpoint_path: str = ""
    config_path: Optional[str] = None

    # augmentation
    p_crop: float = 0.0
    use_elastic: bool = False
    use_speckle: bool = False
    use_tgc: bool = False
    use_clahe: bool = False
    use_mixup: bool = False
    mixup_alpha: float = 0.2
    mixup_prob: float = 0.3
    aug_shared_geometry: bool = False  # one flip/rotation draw a batch
    aug_fast_warp: bool = True  # Paeth warp; False: the exact PIL map

    # model
    model_type: str = "ResUNet"
    model_kwargs: dict = dataclasses.field(default_factory=dict)

    # loss weights
    bce_ratio: float = 1.0
    dice_ratio: float = 0.0
    focal_ratio: float = 1.0
    boundary_ratio: float = 0.0
    compute_unused_losses: bool = True  # the reference computes all four
    alpha: float = 2.0  # weight of the deep-supervision heads' loss

    # training
    num_workers: int = 4          # kept for API parity; host loader only
    epochs: int = 10000
    batch_size: int = 16
    lr: float = 1e-5
    weight_decay: float = 1e-2  # torch AdamW's default, which the
    # reference applies whatever its (unused) flag says
    grad_accum: int = 1  # microbatches a step, one update of their mean
    clip_grad_norm: float = 0.0  # > 0: global-norm clipping ahead of AdamW
    nan_guard: bool = False  # keep the whole state on a non-finite step
    nan_guard_patience: int = 5  # consecutive rejections before stopping
    freeze: str = ""  # comma list of JAX parameter-path prefixes
    freeze_bn_stats: bool = False  # frozen modules' BN statistics pinned
    ema_decay: float = 0.0  # > 0: EMA shadow used by eval, test and saves
    log_every: int = 20
    early_stop_patience: int = 50
    surface_metrics: bool = True  # per-image HD95/ASSD in Trainer.test()
    tta: bool = False  # 4-way flip test-time augmentation in test()
    tune_threshold: bool = False  # test() at the val split's argmax-IoU
    # threshold of a 19-point sweep instead of 0.5
    bn_exact_variance: bool = False  # two-pass BatchNorm variance (torch
    # numerics); the default is flax's one pass, E[x^2] - E[x]^2
    fused_epoch: bool = False  # the train epoch as one captured CUDA graph
    # step replayed (a device store only)
    profile_steps: int = 0  # torch.profiler trace of epoch 1's first N steps

    # deployment (train/export.py, train/quantize.py, train/qat.py)
    export_serving: bool = False  # write the serving bundles after training
    # comma list of batch shapes, one bundle each (a multi-program serving
    # set); None = batch_size
    serving_batches: str | None = None
    serving_dtype: str = "f32"  # exported bundle precision (f32|bf16|int8)
    quant_min_channels: int = 0  # int8 / QAT: only convs with
    # max(cin, cout) >= this
    qat: bool = False  # quantization-aware training: fake-quantized convs
    # (STE) and an activation-range EMA the int8 export takes
    qat_ema_decay: float = 0.99  # amax EMA decay per step under --qat

    # knowledge distillation (train/distill.py): a frozen teacher
    distill_checkpoint: str = ""   # .npz / .pth, or a comma list of them
    distill_model_type: str = ""   # teacher arch ("" = the student's)
    distill_base_filters: int = 0  # teacher width (0 = the student's)
    distill_depth: int = 0         # teacher depth (0 = the student's)
    distill_kwargs: str = ""  # JSON dict of extra teacher create_model kwargs
    distill_weight: float = 0.5    # KD share of the total loss [0, 1]
    distill_temperature: float = 2.0  # sigmoid softening temperature

    # run lifecycle
    save_interval: int = 20  # epochs between rotated full-state saves
    max_keep_checkpoints: int = 3  # rotation depth of those saves
    async_best_save: bool = True  # best-epoch writes on a background
    # thread from on-device copies; False: blocking writes
    best_full_state: bool = False  # also the full train state at every
    # best-IoU epoch (<Model>_last always carries one)

    # parallel / precision / data / device
    use_data_parallel: bool = True  # one rank a GPU where there are several
    mesh_shape: Optional[dict] = None  # a data-parallel run's, {"data": N}
    use_amp_autocast: bool = False  # bf16 autocast
    image_size: int = 512
    store_size: int = 512
    seed: int = 42
    device: str = "cuda"
    host_augment: bool = False     # strict host-oracle augmentation path

    # run dirs (filled by make_dirs)
    base_dir: str = "experiments"
    cfg_dir: str = ""
    model_dir: str = ""
    log_dir: str = ""
    result_dir: str = ""

    def make_dirs(self) -> None:
        os.makedirs(self.base_dir, exist_ok=True)
        ts = datetime.now(timezone.utc).astimezone(_SHANGHAI)
        self.cfg_dir = os.path.join(
            self.base_dir, f"{self.model_type}_{ts.strftime('%Y%m%d_%H%M%S')}")
        self.model_dir = os.path.join(self.cfg_dir, "models")
        self.log_dir = os.path.join(self.cfg_dir, "log")
        self.result_dir = os.path.join(self.cfg_dir, "result")
        for d in (self.cfg_dir, self.model_dir, self.log_dir,
                  self.result_dir):
            os.makedirs(d, exist_ok=True)
        self.save_snapshot()

    def save_snapshot(self) -> None:
        import yaml

        with open(os.path.join(self.cfg_dir, "config.yaml"), "w") as f:
            yaml.safe_dump(dataclasses.asdict(self), f, sort_keys=False)

    def apply_model_yaml(self, path: Optional[str] = None) -> None:
        """Load a ``{model: {model_type, kwargs}}`` YAML (one sweep entry)
        and dispatch the model from it."""
        import yaml

        path = path or self.config_path
        if not path:
            return
        if not os.path.isfile(path):
            raise FileNotFoundError(f"config file not found: {path}")
        with open(path) as f:
            doc = yaml.safe_load(f)
        if not isinstance(doc, dict):
            raise ValueError(
                f"{path} is not a single-run config (got "
                f"{type(doc).__name__}); split the sweep matrix first: "
                f"python -m ddti_tpu_torch.cli.split_config <matrix.yaml> <dir>")
        model = doc.get("model", {})
        if "model_type" in model:
            self.model_type = model["model_type"]
        self.model_kwargs = dict(model.get("kwargs", {}))
