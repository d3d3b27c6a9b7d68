"""Configuration tree of the PyTorch port.

The port's own copy of the parts of ``vitgan_tpu.config`` that the serving and
training slices read.  Field names, defaults and the JSON layout are the JAX
package's, so a JAX run's ``config.json`` loads here unchanged: ``from_dict``
skips the fields this copy does not carry (the JAX-only runtime knobs), and
the JAX package reads the port's ``config.json`` the same way.  The ``mesh``
section travels both ways (parallel/mesh.py reads it).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


def scratch_root() -> str:
    """Artifact root: $SCRATCH, else ~/.vitgan_tpu (vitgan_tpu/config.py:24-27)."""
    return os.environ.get("SCRATCH", os.path.join(os.path.expanduser("~"), ".vitgan_tpu"))


def dev_mode() -> bool:
    """The DEV flag: shrink everything for smoke runs (vitgan_tpu/config.py:30-32)."""
    return os.environ.get("DEV", "").lower() in ("1", "true", "yes")


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
class TransformerConfig:
    """The v1 transformer block's settings."""

    num_heads: int = 4
    attn_dropout: float = 0.2
    mlp_dropout: float = 0.2
    mlp_activation: str = "relu"  # relu | gelu | tanh | sigmoid | leaky_relu
    mlp_hidden: Tuple[int, ...] = ()  # empty: one linear layer


@dataclass(frozen=True)
class SirenConfig:
    omega_0: float = 30.0


@dataclass(frozen=True)
class GeneratorV1Config:
    """The v1 SLN generator with its SIREN head."""

    hidden_size: int = 384
    depth: int = 4
    siren_hidden: int = 768
    transformer: TransformerConfig = field(default_factory=TransformerConfig)
    siren: SirenConfig = field(default_factory=SirenConfig)
    optim: OptimConfig = field(default_factory=lambda: OptimConfig(learning_rate=2e-4))


@dataclass(frozen=True)
class DiscriminatorV1Config:
    """The v1 discriminator: overlapping patches, ISR, L2 attention.
    ``token_size`` None projects to the flattened patch width
    (channels * (patch + 2 * overlap)**2, 432 at the defaults)."""

    depth: int = 4
    patch_size: int = 8
    overlap: int = 2
    token_size: Optional[int] = None
    embed_dropout: float = 0.0
    transformer: TransformerConfig = field(default_factory=TransformerConfig)
    spectral_rescale: bool = True
    optim: OptimConfig = field(default_factory=lambda: OptimConfig(learning_rate=2e-4))


@dataclass(frozen=True)
class V1Config:
    """The v1 ViTGAN (the paper's): widths plus the training knobs of the JAX
    schema, which the train step reads as it reads V2Config's."""

    image_size: int = 32
    channels: int = 3
    batch_size: int = 128
    latent_dim: int = 1024
    seed: int = 0
    generator: GeneratorV1Config = field(default_factory=GeneratorV1Config)
    discriminator: DiscriminatorV1Config = field(default_factory=DiscriminatorV1Config)
    loss: str = "bce"  # bce | mse | wgan-gp
    gp_lambda: float = 10.0
    instance_noise: float = 0.1
    diversity_weight: float = 0.1
    g_diversity: bool = False
    r1_gamma: float = 0.0
    r1_interval: int = 16
    disc_steps: int = 1


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


# The baselines (vitgan_tpu/config.py:242-291): the DCGAN notebook's conv GAN,
# the reference v2 CNNGAN with image-shaped noise, and idc.py's toy MLP GAN.


@dataclass(frozen=True)
class DCGANConfig:
    image_size: int = 32
    channels: int = 3
    batch_size: int = 128
    latent_dim: int = 100
    base_width: int = 64
    seed: int = 999  # the notebook's seed
    gen_optim: OptimConfig = field(default_factory=lambda: OptimConfig(learning_rate=2e-4))
    disc_optim: OptimConfig = field(default_factory=lambda: OptimConfig(learning_rate=2e-4))


@dataclass(frozen=True)
class CNNGANConfig:
    """The v2 CNNGAN: conv G and D; G's input is image-shaped noise, carried
    flat as (B, H*W*C), so ``latent_dim`` is the image's size."""

    image_size: int = 32
    channels: int = 3
    batch_size: int = 64
    seed: int = 0
    gen_optim: OptimConfig = field(
        default_factory=lambda: OptimConfig(name="adamw", learning_rate=5e-4,
                                            beta1=0.9, weight_decay=1e-3)
    )
    disc_optim: OptimConfig = field(
        default_factory=lambda: OptimConfig(name="adamw", learning_rate=5e-4,
                                            beta1=0.9, weight_decay=1e-3)
    )

    @property
    def latent_dim(self) -> int:
        return self.image_size * self.image_size * self.channels


@dataclass(frozen=True)
class MLPGANConfig:
    image_size: int = 32
    channels: int = 3
    batch_size: int = 128
    latent_dim: int = 128
    hidden: Tuple[int, ...] = (256, 512, 1024)
    seed: int = 0
    gen_optim: OptimConfig = field(default_factory=lambda: OptimConfig(learning_rate=2e-4))
    disc_optim: OptimConfig = field(default_factory=lambda: OptimConfig(learning_rate=2e-4))


@dataclass(frozen=True)
class MeshConfig:
    """The device mesh (vitgan_tpu/config.py:294-324): ``data`` is the DP axis,
    ``model`` the TP axis (parallel/mesh.py, parallel/sharding.py), ``pipe``
    the GPipe stages of the ViT block stacks with ``pipeline_microbatches``
    microbatches a step (parallel/pipeline.py), ``seq`` the v2 stacks' token
    axis (parallel/context_parallel.py); pipe and seq do not compose.  The
    port runs one process per device."""

    data_axis: str = "data"
    model_axis: str = "model"
    model_parallel: int = 1  # devices on the model axis
    seq_axis: str = "seq"
    context_parallel: int = 1
    pipe_axis: str = "pipe"
    pipeline_parallel: int = 1
    pipeline_microbatches: int = 2
    # Fully-sharded DP: parameters and both Adam moments are stored sliced
    # over the data axis (the largest divisible dimension of each leaf),
    # gathered before use, their gradients reduce-scattered.
    fsdp: bool = False
    fsdp_min_size: int = 2048  # leaves with fewer elements stay replicated


@dataclass(frozen=True)
class RuntimeConfig:
    """Compute-path knobs the port reads (the JAX schema has more)."""

    compute_dtype: str = "bfloat16"  # activations and matmul operands; parameters stay f32
    # auto | always | never: 'auto' takes a kernel where the tensor is on CUDA
    # and the shape lies inside the kernel's gate (ops/policy.py).
    use_pallas: str = "auto"
    # False/'never' | True/'full' | 'dots' | 'attn': what a v2 training block
    # keeps for its backward and what it re-runs there (ops/policy.remat_mode,
    # models/remat.py).
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
    # The JAX package's buffer donation and lax.scan unroll of its multi-step
    # paths: carried for the schema, read by nothing on the GPU (the port
    # updates the state in place, and its multi-step replays one captured
    # step, train/step.py).
    donate_state: bool = True
    scan_unroll: int = 1


@dataclass(frozen=True)
class DataConfig:
    """The data settings (vitgan_tpu/config.py:372-386)."""

    dataset: str = "cifar10"  # cifar10 | mnist | synthetic
    data_dir: Optional[str] = None  # default: $SCRATCH/data/<dataset> (utils/run_dirs.data_dir)
    shuffle: bool = True
    drop_last: bool = True
    prefetch: int = 2  # batches the host pipeline assembles ahead of the step
    augment_flip: bool = False
    # Carried for the schema, read by nothing: the C++ batch assembler is
    # taken whenever it builds (data/pipeline.py), in both packages.
    num_workers: int = 0
    # Keep the uint8 dataset on the device and assemble batches there when it
    # fits on_device_max_bytes and no partial batch is asked for; otherwise
    # the trainer takes the host pipeline (train/trainer.py).
    on_device: bool = True
    on_device_max_bytes: int = 1 << 29
    synthetic_samples: int = 2048  # dataset size when dataset == "synthetic"


@dataclass(frozen=True)
class TrainRunConfig:
    """The trainer settings the port reads (the JAX schema has more)."""

    epochs: int = 500
    steps_per_epoch: Optional[int] = None  # None => full dataset pass
    checkpoint_every_epochs: int = 50
    sample_grid_every_epochs: int = 1
    fid_every_epochs: int = 1
    fid_num_samples: int = 2560  # ~20 batches of 128 (ref:src/v1/gan.py:207-208)
    best_metric: str = "fid"  # best-model tracking criterion (ref:src/v1/gan.py:77,136-138)
    log_every_steps: int = 50
    keep_checkpoints: int = 3
    diff_augment: str = ""  # DiffAugment spec for D inputs, e.g. "color,translation"
    # Steps per device call; 1 sizes the call from the epoch (train/trainer.py).
    steps_per_call: int = 1
    early_stop_patience: int = 0
    early_stop_min_delta: float = 2.0
    ema_decay: float = 0.0  # >0 keeps an EMA copy of G params
    abort_on_nan: bool = True  # non-finite losses stop the run
    # Collapse detection: epoch-mean D accuracy (the mean of real and fake)
    # >= collapse_acc for collapse_window consecutive epochs logs an error
    # and train/collapse=1; collapse_abort also stops the run.  0 disables.
    collapse_window: int = 10
    collapse_acc: float = 0.98
    collapse_abort: bool = False


@dataclass(frozen=True)
class ExperimentConfig:
    """One model family plus its runtime settings."""

    family: str = "v2"  # v1 | v2 | dcgan | cnn | mlp
    v1: V1Config = field(default_factory=V1Config)
    v2: V2Config = field(default_factory=V2Config)
    dcgan: DCGANConfig = field(default_factory=DCGANConfig)
    cnn: CNNGANConfig = field(default_factory=CNNGANConfig)
    mlp: MLPGANConfig = field(default_factory=MLPGANConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
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


def highres256p4_config() -> ExperimentConfig:
    """256 px at patch 4: 4,096 tokens (4,097 in D with its CLS) of embed 384,
    6 heads of 64, MLP hidden 1,536, depth 12, batch 8, latent 256, under
    remat 'attn' (vitgan_tpu/config.py:556-584)."""
    return replace(ExperimentConfig(family="v2"), **{
        "v2.image_size": 256,
        "v2.embed_dim": 384,
        "v2.depth": 12,
        "v2.num_heads": 6,
        "v2.mlp_ratio": 4,
        "v2.patch_size": 4,
        "v2.batch_size": 8,
        "v2.latent_dim": 256,
        "runtime.remat": "attn",
        "run.diff_augment": "color,translation",
    })


def smoke_config(family: str = "v2") -> ExperimentConfig:
    """Tiny CPU-runnable config: v2 depth 2, embed 32, 2 heads, latent 16; v1
    depth 2, widths 64, latent 64; DCGAN base width 16, the CNNGAN at batch 4
    (its widths are the reference's), the MLP GAN hidden (32, 64); synthetic
    data, 1 epoch of 2 steps (vitgan_tpu/config.py:587-613)."""
    return replace(ExperimentConfig(family=family, data=DataConfig(dataset="synthetic")), **{
        "v2.batch_size": 8,
        "v2.embed_dim": 32,
        "v2.depth": 2,
        "v2.num_heads": 2,
        "v2.latent_dim": 16,
        "v1.batch_size": 8,
        "v1.latent_dim": 64,
        "v1.generator.hidden_size": 64,
        "v1.generator.depth": 2,
        "v1.generator.siren_hidden": 64,
        "v1.discriminator.depth": 2,
        "v1.discriminator.token_size": 64,
        "dcgan.batch_size": 8,
        "dcgan.base_width": 16,
        "cnn.batch_size": 4,
        "mlp.batch_size": 8,
        "mlp.hidden": (32, 64),
        "run.epochs": 1,
        "run.steps_per_epoch": 2,
        "run.fid_num_samples": 16,
        "runtime.use_pallas": "never",
    })
