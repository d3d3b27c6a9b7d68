"""Configuration tree of the PyTorch port.

The port's own copy of the parts of ``vitgan_tpu.config`` that the serving and
training slices read.  Field names, defaults and the JSON layout are the JAX
package's, so a JAX run's ``config.json`` loads here unchanged: ``from_dict``
skips the sections and fields this copy does not carry (mesh, the other model
families, the trainer's checkpoint/FID/collapse settings), and the JAX package
reads the port's ``config.json`` the same way.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass(frozen=True)
class OptimConfig:
    """Per-network optimizer settings (read by the training slice)."""

    name: str = "adam"  # adam | adamw | sgd
    learning_rate: float = 2e-4
    beta1: float = 0.5
    beta2: float = 0.999
    weight_decay: float = 0.0
    grad_clip: Optional[float] = None
    schedule: str = "constant"  # constant | cosine | warmup_cosine
    warmup_steps: int = 0
    decay_steps: Optional[int] = None
    min_lr_ratio: float = 0.0
    grad_accum: int = 1
    inject_lr: bool = False


@dataclass(frozen=True)
class V2Config:
    """The v2 ViT-GAN: model widths plus the training knobs of the JAX schema."""

    image_size: int = 32
    channels: int = 3
    batch_size: int = 64
    embed_dim: int = 128
    depth: int = 6
    num_heads: int = 4
    mlp_ratio: int = 2
    patch_size: int = 4
    dropout: float = 0.1
    latent_dim: int = 128
    epochs: int = 500
    seed: int = 0
    loss: str = "bce"  # bce | wgan-gp
    gp_lambda: float = 10.0
    r1_gamma: float = 0.0
    r1_interval: int = 16
    diversity_weight: float = 0.1
    g_diversity: bool = False
    minibatch_std: bool = False
    instance_noise: float = 0.1
    disc_steps: int = 1
    gen_optim: OptimConfig = field(
        default_factory=lambda: OptimConfig(
            name="adamw", learning_rate=5e-4, beta1=0.9, weight_decay=1e-3, grad_clip=0.5
        )
    )
    disc_optim: OptimConfig = field(
        default_factory=lambda: OptimConfig(
            name="adamw", learning_rate=5e-4, beta1=0.9, weight_decay=1e-3, grad_clip=5.0
        )
    )


@dataclass(frozen=True)
class RuntimeConfig:
    """Compute-path knobs the port reads (the JAX schema has more)."""

    compute_dtype: str = "bfloat16"  # activations and matmul operands; parameters stay f32
    # auto | always | never: 'auto' takes a kernel where the tensor is on CUDA
    # and the shape lies inside the kernel's gate (ops/policy.py).
    use_pallas: str = "auto"
    # False/'never' | True/'full' | 'dots' | 'attn'.  Recorded, not applied:
    # the port keeps every block's activations (ROADMAP.md queue 1 item 12).
    remat: object = False
    # Flash backward: 'fused' single pass, 'two_pass' dq then dk/dv, 'auto'
    # as the JAX package decides (ops/attention.backward_route).
    bwd_fusion: str = "auto"  # auto | fused | two_pass
    megablock: str = "auto"  # off | on | auto (ops/fused_block.maybe_megablock)
    # Samples per grid step of the TPU megablock, a VMEM knob: carried for the
    # schema, read by nothing on the GPU (the CUDA kernels tile by rows).
    megablock_group: int = 8
    # The megablock's training backward: 'saved' (the forward keeps x1, z1,
    # ao and LSE; the backward kernels never re-run a forward product but the
    # qkv projection) | 'recompute' (autograd of the plain block).
    megablock_bwd: str = "saved"


@dataclass(frozen=True)
class DataConfig:
    """The data settings the port reads (the JAX schema has more)."""

    dataset: str = "cifar10"  # cifar10 | mnist | synthetic; the port loads synthetic only
    shuffle: bool = True
    drop_last: bool = True
    augment_flip: bool = False
    synthetic_samples: int = 2048  # dataset size when dataset == "synthetic"


@dataclass(frozen=True)
class TrainRunConfig:
    """The trainer settings the port reads (the JAX schema has more)."""

    epochs: int = 500
    steps_per_epoch: Optional[int] = None  # None => full dataset pass
    log_every_steps: int = 50
    diff_augment: str = ""  # DiffAugment spec for D inputs, e.g. "color,translation"
    ema_decay: float = 0.0  # >0 keeps an EMA copy of G params
    abort_on_nan: bool = True  # non-finite losses stop the run


@dataclass(frozen=True)
class ExperimentConfig:
    """One model family plus its runtime settings."""

    family: str = "v2"
    v2: V2Config = field(default_factory=V2Config)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)
    data: DataConfig = field(default_factory=DataConfig)
    run: TrainRunConfig = field(default_factory=TrainRunConfig)
    run_name: Optional[str] = None  # default: timestamp

    @property
    def model(self):
        return getattr(self, self.family)


def replace(cfg: Any, **kwargs: Any) -> Any:
    """``dataclasses.replace`` that also accepts dotted paths: replace(c, **{'v2.depth': 2})."""
    direct = {k: v for k, v in kwargs.items() if "." not in k}
    nested: dict = {}
    for k, v in kwargs.items():
        if "." in k:
            head, rest = k.split(".", 1)
            nested.setdefault(head, {})[rest] = v
    for head, sub in nested.items():
        direct[head] = replace(getattr(cfg, head), **sub)
    return dataclasses.replace(cfg, **direct)


def to_dict(cfg: ExperimentConfig) -> dict:
    """JSON-safe nested dict of the config."""
    return dataclasses.asdict(cfg)


def from_dict(d: dict, cls: Any = None) -> Any:
    """Inverse of ``to_dict``: rebuild the frozen dataclass tree.

    Skips unknown keys and coerces JSON lists back to tuples.  Nested types
    resolve by name through this module's globals, which is why the
    annotations stay strings (``from __future__ import annotations``).
    """
    cls = cls or ExperimentConfig
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for name, val in d.items():
        if name not in fields:
            continue
        ftype = fields[name].type
        base = ftype.split("[")[0].replace("Optional", "").strip() if isinstance(ftype, str) else ""
        target = globals().get(base)
        if dataclasses.is_dataclass(target) and isinstance(val, dict):
            kwargs[name] = from_dict(val, target)
        elif isinstance(val, list):
            kwargs[name] = tuple(val)
        else:
            kwargs[name] = val
    return cls(**kwargs)


def save_config(cfg: ExperimentConfig, path: str) -> None:
    import json

    with open(path, "w") as f:
        json.dump(to_dict(cfg), f, indent=2, default=str)


def load_config(path: str) -> ExperimentConfig:
    import json

    with open(path) as f:
        return from_dict(json.load(f))


def deit64_config() -> ExperimentConfig:
    """64x64 DeiT-Tiny widths: 256 tokens, embed 192, 3 heads, depth 12."""
    return replace(ExperimentConfig(family="v2"), **{
        "v2.image_size": 64,
        "v2.embed_dim": 192,
        "v2.depth": 12,
        "v2.num_heads": 3,
        "v2.mlp_ratio": 4,
        "v2.patch_size": 4,
        "run.diff_augment": "color,translation,cutout",
    })


def highres_config(image_size: int = 128) -> ExperimentConfig:
    """The deeper transformer generator: at 128px and patch 4, 1,024 tokens of
    embed 384, 6 heads of 64, MLP hidden 1,536, depth 12, latent 256."""
    if image_size not in (128, 256):
        raise ValueError(f"highres_config takes 128 or 256, not {image_size}")
    return replace(ExperimentConfig(family="v2"), **{
        "v2.image_size": image_size,
        "v2.embed_dim": 384,
        "v2.depth": 12,
        "v2.num_heads": 6,
        "v2.mlp_ratio": 4,
        "v2.patch_size": 8 if image_size == 256 else 4,
        "v2.batch_size": 32,
        "v2.latent_dim": 256,
        "runtime.remat": "attn",
        "run.diff_augment": "color,translation",
    })


def smoke_config(family: str = "v2") -> ExperimentConfig:
    """Tiny CPU-runnable config: depth 2, embed 32, 2 heads, latent 16,
    synthetic data, 1 epoch of 2 steps."""
    return replace(ExperimentConfig(family=family, data=DataConfig(dataset="synthetic")), **{
        "v2.batch_size": 8,
        "v2.embed_dim": 32,
        "v2.depth": 2,
        "v2.num_heads": 2,
        "v2.latent_dim": 16,
        "run.epochs": 1,
        "run.steps_per_epoch": 2,
        "runtime.use_pallas": "never",
    })
