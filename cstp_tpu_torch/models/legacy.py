"""The legacy pace-era models (reference ``models/pace/{r21d,c3d,r3d,
s3d_g}.py``), in PyTorch.

The port of ``cstp_tpu/models/legacy.py``. No model name reaches these
models (the reference's live factory dispatches only bare ``r21d``, whose
finetune head is ``CSTPClassify``'s 'pace_project', ``--legacy_pace``);
:func:`make_legacy_model` builds them by their reference file name:

* ``r21d`` -> :class:`LegacyR21DPace`: the R(2+1)D trunk
  (``models/r21d.py``, never with fused conv sites, as in the JAX package)
  with the 'linear' speed head or the 'project' head
  (:class:`LegacyProjector`: Linear-BN-ReLU-Linear and a trailing BN+ReLU);
* ``r21d_byol`` -> :class:`LegacyR21DBYOL`: online and target towers of
  project-headed nets, the ``prodictor`` MLP, the 10x-scaled symmetric
  BYOL regression loss and the ``ft_fc`` classify head. Its EMA belongs to
  a train step, which the JAX package does not build for this model, so
  neither does the port;
* ``c3d`` -> :class:`LegacyC3D`: the C3D trunk, returning the two views'
  features, and ``cls``;
* ``r3d`` -> :class:`LegacyR3DNet`: a full-3D-conv ResNet (R(2+1)D's layer
  layout, unfactorised) whose blocks sum their residual in the compute
  dtype, with a 4-way speed head;
* ``s3d_g`` -> :class:`LegacyS3DG`: the MIL-NCE-style S3D-G, self-gated
  after ``conv_2c`` and in every Inception branch (always: the reference's
  flag is overwritten), TF-SAME max pools, and the space-to-depth stem,
  which crops one leading element of T, H and W after ``conv1``.

NDHWC activations, ``dtype`` compute, float32 parameters and BN. Module
names are the JAX package's, so ``models/bridge.py`` maps weights by
rename; the bare ``nn.Conv`` layers of the JAX package sit one level down
(``conv1/conv/kernel`` in a 3D-ResNet block, ``conv1/conv1/kernel`` in an
S3D-G unit), as the port's ``Conv3d`` attributes do.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from cstp_tpu_torch.models.c3d import C3D
from cstp_tpu_torch.models.layers import (
    INCEPTION_PLAN,
    BatchNorm,
    Conv3d,
    Dense,
    MLPHead,
    SelfGating,
    _triple,
    max_pool_3d,
    max_pool_3d_same,
)
from cstp_tpu_torch.models.r21d import R2Plus1DNet
from cstp_tpu_torch.models.s3dg import space_to_depth_stem
from cstp_tpu_torch.ssl.byol import byol_regression_loss


class LegacyProjector(nn.Module):
    """Linear-BN-ReLU-Linear (``mlp``), then BN (``bn2``) and a float32
    ReLU (``pace/r21d.py:242-256``)."""

    def __init__(self, in_dim: int = 512, out: int = 512, hidden: int = 4096,
                 dtype=torch.bfloat16, bn_groups: int = 1,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.mlp = MLPHead(in_dim, hidden, out, dtype, bn_groups, gen)
        self.bn2 = BatchNorm(out, bn_groups, gen)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        return torch.relu(self.bn2(self.mlp(x, train), train).float())


class LegacyR21DPace(nn.Module):
    """``pace/r21d.py`` R2Plus1DNet (lines 184-238): ``linear_flag``
    'linear' -> a float32 Linear(512, num_classes) speed head, anything
    else -> the 512-d :class:`LegacyProjector` output."""

    def __init__(self, linear_flag: str = "project", num_classes: int = 4,
                 layer_sizes: Tuple[int, int, int, int] = (1, 1, 1, 1),
                 dtype=torch.bfloat16, bn_groups: int = 1,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.linear_flag = linear_flag
        self.trunk = R2Plus1DNet(layer_sizes, False, dtype, bn_groups,
                                 False, gen)
        if linear_flag == "linear":
            self.linear = Dense(512, num_classes, torch.float32, gen)
        else:
            self.project = LegacyProjector(dtype=dtype, bn_groups=bn_groups,
                                           gen=gen)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        feat = self.trunk(x, train)
        if self.linear_flag == "linear":
            return self.linear(feat)
        return self.project(feat, train)


class LegacyR21DBYOL(nn.Module):
    """``pace/r21d.py`` R21DBYOL (lines 271-357): the forward is
    ``o_type='r_byol'``, ``classify_forward`` is ``o_type='ft_fc'``. The
    target tower runs without autograd (the JAX package's
    ``stop_gradient``); ``momentum`` is kept for a train step's EMA."""

    def __init__(self, num_classes: int = 4, momentum: float = 0.996,
                 layer_sizes: Tuple[int, int, int, int] = (1, 1, 1, 1),
                 dtype=torch.bfloat16, bn_groups: int = 1,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.momentum = momentum
        kw = dict(linear_flag="project", layer_sizes=layer_sizes,
                  dtype=dtype, bn_groups=bn_groups, gen=gen)
        self.online_net = LegacyR21DPace(**kw)
        self.target_net = LegacyR21DPace(**kw)
        self.prodictor = MLPHead(512, 4096, 512, dtype, bn_groups, gen)
        self.classify = Dense(512, num_classes, torch.float32, gen)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor,
                train: bool = True) -> torch.Tensor:
        """Mean over the batch of ``10 * (reg(o1, t2) + reg(o2, t1))``."""
        o1 = self.prodictor(self.online_net(x1, train), train)
        o2 = self.prodictor(self.online_net(x2, train), train)
        with torch.no_grad():
            t1 = self.target_net(x1, train)
            t2 = self.target_net(x2, train)
        loss = byol_regression_loss(o1, t2) + byol_regression_loss(o2, t1)
        return (10.0 * loss).mean()

    def classify_forward(self, x: torch.Tensor,
                         train: bool = False) -> torch.Tensor:
        """The online tower's 512-d projector output, classified."""
        return self.classify(self.online_net(x, train))


class LegacyC3D(nn.Module):
    """``pace/c3d.py`` C3D (lines 26-117): the forward (``o_type='ctr'``)
    gives the two clips' 512-d features, ``cls`` the classify head's
    logits of one clip."""

    def __init__(self, num_classes: int = 4, dtype=torch.bfloat16,
                 bn_groups: int = 1, gen: Optional[torch.Generator] = None):
        super().__init__()
        self.trunk = C3D(dtype, bn_groups, gen)
        self.classify = Dense(512, num_classes, torch.float32, gen)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor,
                train: bool = True):
        return self.trunk(x1, train), self.trunk(x2, train)

    def cls(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        return self.classify(self.trunk(x, train))


class _FullConv3d(nn.Module):
    """``pace/r3d.py`` SpatioTemporalConv: a plain 3D conv without bias."""

    def __init__(self, in_ch: int, features: int, kernel, stride=1,
                 padding=0, dtype=torch.bfloat16,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = Conv3d(in_ch, features, kernel, stride, padding, dtype,
                           gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class _LegacyR3DBlock(nn.Module):
    """``pace/r3d.py`` SpatioTemporalResBlock: 3^3 conv-BN-ReLU-conv-BN
    plus the shortcut (a strided 1x1x1 conv and BN with ``downsample``),
    summed and ReLU'd in the compute dtype."""

    def __init__(self, in_ch: int, features: int, downsample: bool = False,
                 dtype=torch.bfloat16, bn_groups: int = 1,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.downsample = downsample
        stride = 2 if downsample else 1
        self.conv1 = _FullConv3d(in_ch, features, 3, stride, 1, dtype, gen)
        self.bn1 = BatchNorm(features, bn_groups, gen)
        self.conv2 = _FullConv3d(features, features, 3, 1, 1, dtype, gen)
        self.bn2 = BatchNorm(features, bn_groups, gen)
        if downsample:
            self.downsampleconv = _FullConv3d(in_ch, features, 1, 2, 0, dtype,
                                              gen)
            self.downsamplebn = BatchNorm(features, bn_groups, gen)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        res = torch.relu(self.bn1(self.conv1(x), train)).to(self.dtype)
        res = self.bn2(self.conv2(res), train)
        if self.downsample:
            x = self.downsamplebn(self.downsampleconv(x), train)
        return torch.relu(x + res).to(self.dtype)


class LegacyR3DNet(nn.Module):
    """``pace/r3d.py`` R3DNet (lines 125-167): a (3,7,7) stem with stride
    (1,2,2), four stages of ``layer_sizes`` blocks named
    ``conv{i}_b{j}`` (the first of stages 3-5 downsampling), a float32 mean
    and the float32 ``linear`` head."""

    def __init__(self, layer_sizes: Tuple[int, int, int, int] = (1, 1, 1, 1),
                 num_classes: int = 4, dtype=torch.bfloat16,
                 bn_groups: int = 1, gen: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _FullConv3d(3, 64, (3, 7, 7), (1, 2, 2), (1, 3, 3),
                                 dtype, gen)
        self.bn1 = BatchNorm(64, bn_groups, gen)
        self.names = []
        in_ch = 64
        for i, (feats, down) in enumerate(zip((64, 128, 256, 512),
                                              (False, True, True, True))):
            for b in range(layer_sizes[i]):
                name = f"conv{i + 2}_b{b + 1}"
                setattr(self, name, _LegacyR3DBlock(
                    in_ch, feats, down and b == 0, dtype, bn_groups, gen))
                self.names.append(name)
                in_ch = feats
        self.linear = Dense(512, num_classes, torch.float32, gen)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = self.conv1(x.to(self.dtype))
        x = torch.relu(self.bn1(x, train)).to(self.dtype)
        for name in self.names:
            x = getattr(self, name)(x, train)
        return self.linear(x.float().mean(dim=(1, 2, 3)))


class _LegacySTConv3d(nn.Module):
    """``pace/s3d_g.py`` STConv3D: conv-BN-ReLU (``conv1``/``bn1``); when
    ``separable`` and the temporal kernel is not 1, the spatial part there
    and the temporal conv-BN-ReLU after it (``conv2``/``bn2``)."""

    def __init__(self, in_ch: int, features: int, kernel, stride=1,
                 padding=0, separable: bool = False, dtype=torch.bfloat16,
                 bn_groups: int = 1, gen: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        kt, kh, kw = _triple(kernel)
        st, sh, sw = _triple(stride)
        pt, ph, pw = _triple(padding)
        self.separable = separable and kt != 1
        if self.separable:
            self.conv1 = Conv3d(in_ch, features, (1, kh, kw), (1, sh, sw),
                                (0, ph, pw), dtype, gen)
            self.bn1 = BatchNorm(features, bn_groups, gen)
            self.conv2 = Conv3d(features, features, (kt, 1, 1), (st, 1, 1),
                                (pt, 0, 0), dtype, gen)
            self.bn2 = BatchNorm(features, bn_groups, gen)
        else:
            self.conv1 = Conv3d(in_ch, features, kernel, stride, padding,
                                dtype, gen)
            self.bn1 = BatchNorm(features, bn_groups, gen)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x), train)).to(self.dtype)
        if self.separable:
            x = torch.relu(self.bn2(self.conv2(x), train)).to(self.dtype)
        return x


class _LegacyInception(nn.Module):
    """``pace/s3d_g.py`` InceptionBlock: four branches (``out_planes`` =
    [b0, b1a, b1b, b2a, b2b, b3b]), each self-gated."""

    def __init__(self, in_ch: int, out_planes: Sequence[int],
                 dtype=torch.bfloat16, bn_groups: int = 1,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        b0, b1a, b1b, b2a, b2b, b3b = out_planes
        kw = dict(dtype=dtype, bn_groups=bn_groups, gen=gen)
        self.conv_b0 = _LegacySTConv3d(in_ch, b0, 1, **kw)
        self.conv_b1_a = _LegacySTConv3d(in_ch, b1a, 1, **kw)
        self.conv_b1_b = _LegacySTConv3d(b1a, b1b, 3, padding=1,
                                         separable=True, **kw)
        self.conv_b2_a = _LegacySTConv3d(in_ch, b2a, 1, **kw)
        self.conv_b2_b = _LegacySTConv3d(b2a, b2b, 3, padding=1,
                                         separable=True, **kw)
        self.conv_b3_b = _LegacySTConv3d(in_ch, b3b, 1, **kw)
        for i, c in enumerate((b0, b1b, b2b, b3b)):
            setattr(self, f"gating_b{i}", SelfGating(c, gen))
        self.out_ch = b0 + b1b + b2b + b3b

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        xs = [self.conv_b0(x, train),
              self.conv_b1_b(self.conv_b1_a(x, train), train),
              self.conv_b2_b(self.conv_b2_a(x, train), train),
              self.conv_b3_b(max_pool_3d(x, 3, 1, 1), train)]
        return torch.cat([getattr(self, f"gating_b{i}")(v)
                          for i, v in enumerate(xs)], dim=-1)


# the TF-SAME max pool ahead of a block: (kernel, stride)
_LEGACY_POOL_BEFORE = {"mixed_4b": ((3, 3, 3), (2, 2, 2)),
                       "mixed_5b": ((2, 2, 2), (2, 2, 2))}


class LegacyS3DG(nn.Module):
    """``pace/s3d_g.py`` S3D (lines 222-330), the MIL-NCE-style S3D-G:
    a non-separable stem (with ``space_to_depth``: the 2x2x2 cells on the
    channel axis, a (2,4,4) conv, then T, H and W cropped by one leading
    element), ``conv_2b``, separable ``conv_2c``, self-gating, the gated
    Inception blocks ``mixed_*`` with TF-SAME max pools, a float32 mean and
    the float32 ``fc`` head of ``num_classes`` outputs."""

    def __init__(self, num_classes: int = 512, space_to_depth: bool = True,
                 dtype=torch.bfloat16, bn_groups: int = 1,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.space_to_depth = space_to_depth
        kw = dict(dtype=dtype, bn_groups=bn_groups, gen=gen)
        if space_to_depth:
            self.conv1 = _LegacySTConv3d(24, 64, (2, 4, 4), 1, (1, 2, 2), **kw)
        else:
            self.conv1 = _LegacySTConv3d(3, 64, (3, 7, 7), 2, (1, 3, 3), **kw)
        self.conv_2b = _LegacySTConv3d(64, 64, 1, **kw)
        self.conv_2c = _LegacySTConv3d(64, 192, 3, padding=1, separable=True,
                                       **kw)
        self.gating = SelfGating(192, gen)
        self.names = []
        in_ch = 192
        for suffix, plan in INCEPTION_PLAN:
            name = f"mixed_{suffix}"
            block = _LegacyInception(in_ch, plan, **kw)
            setattr(self, name, block)
            self.names.append(name)
            in_ch = block.out_ch
        self.fc = Dense(in_ch, num_classes, torch.float32, gen)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.space_to_depth:
            x = self.conv1(space_to_depth_stem(x), train)[:, 1:, 1:, 1:, :]
        else:
            x = self.conv1(x, train)
        x = max_pool_3d_same(x, (1, 3, 3), (1, 2, 2))
        x = self.conv_2c(self.conv_2b(x, train), train)
        x = self.gating(x)
        x = max_pool_3d_same(x, (1, 3, 3), (1, 2, 2))
        for name in self.names:
            if name in _LEGACY_POOL_BEFORE:
                x = max_pool_3d_same(x, *_LEGACY_POOL_BEFORE[name])
            x = getattr(self, name)(x, train)
        return self.fc(x.float().mean(dim=(1, 2, 3)))


_LEGACY = {
    "r21d": LegacyR21DPace,
    "r21d_byol": LegacyR21DBYOL,
    "c3d": LegacyC3D,
    "r3d": LegacyR3DNet,
    "s3d_g": LegacyS3DG,
}


def make_legacy_model(name: str, **kwargs) -> nn.Module:
    """The legacy pace model of the reference file ``name`` ('r21d',
    'r21d_byol', 'c3d', 'r3d', 's3d_g'); ``kwargs`` go to its class."""
    if name not in _LEGACY:
        raise ValueError(f"unknown legacy model {name!r}; have "
                         f"{sorted(_LEGACY)}")
    return _LEGACY[name](**kwargs)
