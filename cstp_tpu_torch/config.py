"""Config for the PyTorch port: the same fields, defaults and ``finalize()``
checks as the JAX package's ``Config``, kept as the port's own copy.

Flags whose code paths the port does not have yet raise
``NotImplementedError`` from ``finalize()`` instead of being ignored.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass
class Config:
    # ---- datasets ----
    frame_dir: str = "dataset/UCF101/"
    annotation_path: str = "dataset/UCF101_labels"
    dataset: str = "UCF101"
    split: str = "1"
    modality: str = "RGB"
    input_channels: int = 3
    n_classes: int = 101
    n_finetune_classes: int = 101

    # ---- model ----
    model_name: str = "r21d_byol"
    model_depth: int = 1
    resnet_shortcut: str = "B"
    ft_begin_index: int = 0
    sample_size: int = 112
    sample_duration: int = 16
    batch_size: int = 32          # GLOBAL batch
    n_workers: int = 4
    pretrained_path: str = ""
    test_md_path: str = ""
    resume_md_path: str = ""

    # ---- optimizer ----
    learning_rate: float = 3e-4
    momentum: float = 0.9
    dampening: float = 0.0
    weight_decay: float = 1e-4
    nesterov: bool = False
    double_bias_lr: bool = False
    optimizer: str = "sgd"
    lr_patience: int = 10
    n_epochs: int = 400

    # ---- logging / misc ----
    result_path: str = "results"
    manual_seed: int = 1
    task: str = "loss_com"        # loss_com/r_byol/ft_fc/ft_all/scratch/test/resume
    temperature: float = 0.5
    lr_decay: float = 1e-4
    sync_bn: int = 1
    clip_grad_norm: int = 1
    clip_grad_value: float = 18.0
    pb_rate: int = 4
    tau: int = 8
    alpha: int = 4
    transform_mode: str = "img"
    input_size: int = 320
    output_feat: int = 128
    norm_method: str = "tf"
    loss_weight: Tuple[float, ...] = (0.1, 1.0, 1.0, 1.0, 1.0)
    t_ft_task: str = ""
    sc_type: str = "B"
    lmdb_path: str = ""
    steps_per_epoch: int = 0
    cls_bn: bool = True
    legacy_pace: int = 0
    i3d_conv_head: int = 0

    # ---- accelerator knobs (names kept from the JAX package) ----
    mesh_shape: Tuple[int, ...] = (-1, 1)
    mesh_axes: Tuple[str, ...] = ("data", "model")
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    byol_momentum: float = 0.996
    prefetch_depth: int = 2
    log_every: int = 1
    profile_dir: str = ""
    profile_steps: int = 5
    tb_dir: str = ""
    ckpt_every_epochs: int = 100
    device_augment: bool = True
    ntxent_weight: float = 0.0
    s2d_stem: bool = False
    pallas_augment: str = "auto"            # fused augment kernel: auto|on|off
    tpu_vmem_limit_kib: int = 65536         # read by the JAX package only
    shard_opt_state: int = 0
    shard_spatial: int = 0
    ema_ref_batch: int = 0
    remat: bool = False
    remat_policy: str = ""
    concat_views: int = 1
    tf_i3d_ckpt: str = ""
    data_echo: int = 1
    grad_accum: int = 1
    auto_resume: bool = False
    graceful_preempt: int = 1
    data_backend: str = "framedir"
    synthetic_len: int = 256
    synthetic_learnable: int = 0
    fused_conv: int = 0                     # fused (2+1)D stride-1 blocks:
                                            # 1 = both towers, 2 = target only
    retrieval_clips: int = 10
    mid_round: int = 1
    t_fold: int = 0
    quant: str = ""
    quant_scope: str = "all"

    _TRAIN_TASKS = ("loss_com", "r_byol", "ft_fc", "ft_all", "scratch",
                    "resume")

    def finalize(self) -> "Config":
        """Validate and derive fields; returns self for chaining."""
        assert self.task in (
            "loss_com", "r_byol", "ft_fc", "ft_all", "scratch", "test",
            "resume", "retrieval",
        ), f"unknown task {self.task}"
        assert self.optimizer in ("sgd", "adam", "adamw")
        if isinstance(self.loss_weight, (int, float)):
            self.loss_weight = (float(self.loss_weight),) * 5
        self.loss_weight = tuple(float(w) for w in self.loss_weight)
        assert len(self.loss_weight) == 5, "loss_weight must be 5 floats"
        assert self.grad_accum >= 1, "--grad_accum must be >= 1"

        if (self.quant in ("int8_static", "int8_calib")
                and self.task in self._TRAIN_TASKS):
            raise ValueError(
                f"--quant {self.quant} is an eval/serve/calibration mode "
                f"and --task {self.task} drives a TRAINING step.")
        if self.quant in ("int8_store", "int8_store_fz"):
            if not self.model_name.startswith("r21d"):
                raise ValueError(
                    f"--quant {self.quant} is implemented for the r21d "
                    "factorized chain only.")
            for flag in ("s2d_stem", "t_fold", "fused_conv"):
                if getattr(self, flag):
                    raise ValueError(
                        f"--quant {self.quant} and --{flag} rewrite the "
                        "same factorized (2+1)D chain and are exclusive.")
        if self.fused_conv and self.quant:
            raise ValueError(
                f"--fused_conv with --quant {self.quant}: the fused blocks "
                "always run float. Drop one of the two flags.")
        if self.fused_conv and self.t_fold:
            raise ValueError(
                "--fused_conv and --t_fold are conflicting rewrites of the "
                "factorized conv chain. Pick one.")
        if self.shard_spatial:
            axes = tuple(self.mesh_axes)
            if "model" not in axes:
                raise ValueError(
                    "--shard_spatial 1 needs a 'model' mesh axis.")
            m = tuple(self.mesh_shape)[axes.index("model")]
            if m != -1 and m <= 1:
                raise ValueError(
                    f"--shard_spatial 1 with --mesh_shape {self.mesh_shape}"
                    ": the 'model' axis has size 1.")
        if self.batch_size % self.grad_accum:
            raise ValueError(
                f"--batch_size {self.batch_size} is not divisible by "
                f"--grad_accum {self.grad_accum}.")
        self.check_ported()
        return self

    @property
    def arch(self) -> str:
        """The checkpoint's arch tag, ``{model_name}-{model_depth}``."""
        return f"{self.model_name}-{self.model_depth}"

    def check_ported(self) -> None:
        """Refuse flag values whose code paths the port does not have."""
        unported = {
            "concat_views 0": not self.concat_views,
            "remat": bool(self.remat),
            "remat_policy": bool(self.remat_policy),
            "s2d_stem": bool(self.s2d_stem),
            "t_fold": bool(self.t_fold),
            "quant": bool(self.quant),
            "mid_round > 1": self.mid_round > 1,
            "ntxent_weight > 0": self.ntxent_weight > 0,
            "shard_opt_state": bool(self.shard_opt_state),
            "shard_spatial": bool(self.shard_spatial),
            f"model_name {self.model_name}":
                base_model_name(self.model_name) != "r21d",
            f"optimizer {self.optimizer}": self.optimizer != "sgd",
            "dampening != 0": self.dampening != 0.0,
            "nesterov": bool(self.nesterov),
            "double_bias_lr": bool(self.double_bias_lr),
            "legacy_pace": bool(self.legacy_pace),
            "i3d_conv_head": bool(self.i3d_conv_head),
            "tf_i3d_ckpt": bool(self.tf_i3d_ckpt),
            "task resume": self.task == "resume",
        }
        bad = [k for k, v in unported.items() if v]
        if bad:
            raise NotImplementedError(
                "cstp_tpu_torch does not port these flag values yet: "
                + ", ".join(bad))
        if self.fused_conv not in (0, 1, 2):
            raise ValueError(f"--fused_conv must be 0, 1 or 2, got "
                             f"{self.fused_conv}")
        if self.pallas_augment not in ("auto", "on", "off"):
            raise ValueError(f"--pallas_augment {self.pallas_augment!r}")


def base_model_name(arch: str) -> str:
    """'r21d_byol' / 'r21d_classify' -> 'r21d'."""
    for suffix in ("_byol", "_classify"):
        if arch.endswith(suffix):
            return arch[: -len(suffix)]
    return arch
