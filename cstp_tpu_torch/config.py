"""Config for the PyTorch port: the same fields, defaults, ``finalize()``
checks and command-line flags (``parse_opts``) as the JAX package's
``Config``, kept as the port's own copy.

Flags whose code paths the port does not have yet raise
``NotImplementedError`` from ``finalize()`` instead of being ignored; an
unknown ``model_name`` raises ``ValueError`` there, as the JAX package's
``make_backbone`` does. Flags that only the TPU reads
(``--tpu_vmem_limit_kib``) are accepted and unused.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import warnings
from dataclasses import dataclass
from typing import List, Optional, Tuple


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

    # bare names that select the reference's legacy contrastive variants
    _LEGACY_BARE_NAMES = ("r21d", "c3d", "r3d", "s3d")

    _TRAIN_TASKS = ("loss_com", "r_byol", "ft_fc", "ft_all", "scratch",
                    "resume")

    def warn_if_legacy_model_name(self) -> None:
        """Warn when a bare legacy name is used: in the reference, bare
        'r21d'/'c3d'/'s3d'/'r3d' select the legacy pace contrastive
        variants (``models/legacy.py`` rebuilds them as modules), and the
        ``*_byol`` family model is built instead; ``--legacy_pace 1`` gives
        bare 'r21d' the reference's live finetune head. Called from
        ``parse_opts`` only; the text is the JAX package's."""
        if self.model_name in self._LEGACY_BARE_NAMES:
            warnings.warn(
                f"--model_name {self.model_name!r}: in the reference this "
                "bare name selects the LEGACY pace contrastive variant "
                f"(models/pace/{'s3d_g' if self.model_name == 's3d' else self.model_name}.py), which this framework "
                "deliberately does not rebuild by default (see PARITY.md "
                f"'Known deviations'). Building the {self.model_name}_byol-"
                "family model instead; its 10x-scaled BYOL loss is "
                "expressible as --loss_weight 10 1 1 1 1. The reference's "
                "live bare-'r21d' finetune behavior (CE over a 512-d "
                "Projector output, models/model.py:41-43) is available with "
                "--legacy_pace 1.",
                stacklevel=2,
            )

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

    @property
    def clip_stride(self) -> int:
        """Finetune/test frame stride: ``pb_rate``; for slowfast models the
        fast pathway's stride ``tau // alpha``."""
        if self.model_name.startswith("slowfast"):
            return max(1, self.tau // self.alpha)
        return self.pb_rate

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        d = json.loads(s)
        known = {f.name for f in dataclasses.fields(cls)}
        d = {k: v for k, v in d.items() if k in known}
        for k in ("loss_weight", "mesh_shape", "mesh_axes"):
            if k in d and isinstance(d[k], list):
                d[k] = tuple(d[k])
        return cls(**d).finalize()

    def check_ported(self) -> None:
        """Refuse flag values whose code paths the port does not have."""
        unported = {
            "s2d_stem": bool(self.s2d_stem),
            "t_fold": bool(self.t_fold),
            "quant": bool(self.quant),
            "mid_round > 1": self.mid_round > 1,
            "ntxent_weight > 0": self.ntxent_weight > 0,
            "shard_opt_state": bool(self.shard_opt_state),
            "shard_spatial": bool(self.shard_spatial),
        }
        bad = [k for k, v in unported.items() if v]
        if bad:
            raise NotImplementedError(
                "cstp_tpu_torch does not port these flag values yet: "
                + ", ".join(bad))
        if base_model_name(self.model_name) not in PORTED_FAMILIES:
            raise ValueError(f"unknown backbone {self.model_name!r}; have "
                             f"{sorted(PORTED_FAMILIES)}")
        if self.fused_conv not in (0, 1, 2):
            raise ValueError(f"--fused_conv must be 0, 1 or 2, got "
                             f"{self.fused_conv}")
        if self.pallas_augment not in ("auto", "on", "off"):
            raise ValueError(f"--pallas_augment {self.pallas_augment!r}")
        if self.remat_policy not in ("", "bnrelu"):
            raise ValueError(f"--remat_policy must be '' or 'bnrelu', got "
                             f"{self.remat_policy!r}")


# backbone families the port builds (models/__init__.py): every family the
# JAX package registers
PORTED_FAMILIES = ("r21d", "c3d", "r3d", "s3d", "i3d", "slowfast",
                   "slowfast_fb")


def base_model_name(arch: str) -> str:
    """'r21d_byol' / 'r21d_classify' -> 'r21d'."""
    for suffix in ("_byol", "_classify"):
        if arch.endswith(suffix):
            return arch[: -len(suffix)]
    return arch


def _add_args(parser: argparse.ArgumentParser) -> None:
    """The JAX package's flag surface: the reference's ``opts.py`` names,
    the same defaults."""
    c = Config()
    for name, typ in (
            ("frame_dir", str), ("annotation_path", str), ("dataset", str),
            ("split", str), ("modality", str), ("input_channels", int),
            ("n_classes", int), ("n_finetune_classes", int),
            ("model_name", str), ("model_depth", int),
            ("resnet_shortcut", str), ("ft_begin_index", int),
            ("sample_size", int), ("sample_duration", int),
            ("batch_size", int), ("n_workers", int),
            ("pretrained_path", str), ("test_md_path", str),
            ("resume_md_path", str), ("learning_rate", float),
            ("momentum", float), ("dampening", float),
            ("weight_decay", float)):
        parser.add_argument(f"--{name}", default=getattr(c, name), type=typ)
    for name in ("nesterov", "double_bias_lr", "remat"):
        parser.add_argument(f"--{name}", action="store_true")
    parser.add_argument("--remat_policy", default=c.remat_policy,
                        choices=["", "bnrelu"])
    for name, typ in (
            ("concat_views", int), ("optimizer", str), ("lr_patience", int),
            ("n_epochs", int), ("result_path", str), ("manual_seed", int),
            ("task", str), ("temperature", float), ("lr_decay", float),
            ("sync_bn", int), ("clip_grad_norm", int), ("pb_rate", int)):
        parser.add_argument(f"--{name}", default=getattr(c, name), type=typ)
    parser.add_argument("--tau", default=c.tau, type=int,
                        help="slowfast: slow-path temporal stride")
    parser.add_argument("--alpha", default=c.alpha, type=int,
                        help="slowfast: fast/slow frame-rate ratio")
    for name, typ in (
            ("transform_mode", str), ("input_size", int),
            ("output_feat", int), ("norm_method", str)):
        parser.add_argument(f"--{name}", default=getattr(c, name), type=typ)
    parser.add_argument("--loss_weight", default=list(c.loss_weight),
                        nargs="+", type=float)
    for name, typ in (
            ("t_ft_task", str), ("sc_type", str), ("lmdb_path", str),
            ("steps_per_epoch", int)):
        parser.add_argument(f"--{name}", default=getattr(c, name), type=typ)
    parser.add_argument("--mesh_shape", default=list(c.mesh_shape),
                        nargs="+", type=int)
    for name, typ in (
            ("compute_dtype", str), ("byol_momentum", float),
            ("data_backend", str), ("synthetic_len", int),
            ("synthetic_learnable", int), ("fused_conv", int),
            ("mid_round", int), ("t_fold", int)):
        parser.add_argument(f"--{name}", default=getattr(c, name), type=typ)
    parser.add_argument("--quant", default=c.quant,
                        choices=["", "int8", "int8_fixed", "int8_static",
                                 "int8_calib", "int8_store", "int8_store_fz"])
    parser.add_argument("--quant_scope", default=c.quant_scope,
                        choices=["all", "target"])
    for name, typ in (
            ("legacy_pace", int), ("i3d_conv_head", int),
            ("ckpt_every_epochs", int), ("log_every", int),
            ("profile_dir", str), ("tb_dir", str), ("profile_steps", int),
            ("ntxent_weight", float)):
        parser.add_argument(f"--{name}", default=getattr(c, name), type=typ)
    parser.add_argument("--s2d_stem", action="store_true")
    parser.add_argument("--pallas_augment", default=c.pallas_augment,
                        choices=["auto", "on", "off"])
    for name, typ in (
            ("tpu_vmem_limit_kib", int), ("ema_ref_batch", int),
            ("shard_opt_state", int), ("shard_spatial", int),
            ("tf_i3d_ckpt", str), ("data_echo", int), ("grad_accum", int)):
        parser.add_argument(f"--{name}", default=getattr(c, name), type=typ)
    parser.add_argument("--auto_resume", action="store_true")
    parser.add_argument("--graceful_preempt", default=c.graceful_preempt,
                        type=int)
    parser.add_argument("--retrieval_clips", default=c.retrieval_clips,
                        type=int)


def parse_opts(argv: Optional[List[str]] = None) -> Config:
    """The command line -> a finalized ``Config`` (the reference's
    ``parse_opts()``)."""
    parser = argparse.ArgumentParser(description="cstp_tpu_torch")
    _add_args(parser)
    d = vars(parser.parse_args(argv))
    d["loss_weight"] = tuple(d["loss_weight"])
    d["mesh_shape"] = tuple(d["mesh_shape"])
    known = {f.name for f in dataclasses.fields(Config)}
    cfg = Config(**{k: v for k, v in d.items() if k in known}).finalize()
    cfg.warn_if_legacy_model_name()
    return cfg
