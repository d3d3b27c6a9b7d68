"""chip_smoke.py's profiled breakdown files every kernel of the port under a
port label: each ``__global__`` function of vitgan_tpu_torch/ops/csrc, named
as the profiler names it (demangled, with ``float`` and ``__nv_bfloat16``,
``true`` and ``false`` and small integers as template arguments), is neither
a library matrix product nor "other elementwise and reductions" on either
LN->MLP route; the f32 step's kernels land in the groups that name them."""

import glob
import os
import re

import pytest

import chip_smoke

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "vitgan_tpu_torch", "ops", "csrc")
_GLOBAL = re.compile(r"(?:template\s*<([^>]*)>\s*)?__global__\s+void\s+"
                     r"(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(", re.S)
# template arguments by parameter kind; instantiation k takes argument k of
# each list (cyclically)
_ARGS = {"int": ("0", "1", "2"), "bool": ("true", "false"),
         "typename": ("float", "__nv_bfloat16")}
LIBRARY = "library matrix products (cuBLAS/CUTLASS)"
OTHER = "other elementwise and reductions"


def _symbols():
    """Demangled symbols of every kernel in csrc/: one per non-template
    kernel, three instantiations of each template."""
    out = []
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        with open(path) as f:
            src = f.read()
        for params, name in _GLOBAL.findall(src):
            kinds = [p.split()[0] for p in params.split(",")] if params.strip() else []
            if not kinds:
                out.append(f"void vk::k::{name}(vk::k::Params)")
                continue
            for k in range(3):
                args = ", ".join(_ARGS[kind][k % len(_ARGS[kind])] for kind in kinds)
                out.append(f"void vk::k::{name}<{args}>(vk::k::Params)")
    return sorted(set(out))


SYMBOLS = _symbols()


def test_the_sources_hold_the_kernels_the_breakdown_names():
    names = {re.search(r"::(\w+)[<(]", s).group(1) for s in SYMBOLS}
    assert {"tile_f32_kernel", "ln_norm_f32_kernel",
            "wgrad_tf32_kernel", "ln_bwd_rows_kernel", "mask_rows_kernel",
            "megablock_bwd_mlp_rows_kernel", "flash_fwd_f32_kernel"} <= names
    assert len(names) >= 25


@pytest.mark.parametrize("symbol", SYMBOLS)
def test_every_port_kernel_takes_a_port_label(symbol):
    for route in ("auto", "off"):
        assert chip_smoke._kernel_group(symbol, route) not in (LIBRARY, OTHER), (symbol, route)


@pytest.mark.parametrize("symbol,label", [
    ("void vk::tilef32::tile_f32_kernel<0, 0>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, vk::tilef32::Params)", "megablock backward f32: dz1 (A.W^T tile)"),
    ("void vk::tilef32::tile_f32_kernel<1, 0>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, vk::tilef32::Params)", "megablock backward f32: dy2, dy1 (A.W^T tile)"),
    ("void vk::tilef32::tile_f32_kernel<2, 0>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, vk::tilef32::Params)", "megablock backward f32: dao, delta (A.W^T tile)"),
    ("void vk::tilef32::tile_f32_kernel<3, 0>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, vk::tilef32::Params)", "LN->fc1 (f32)"),
    ("void vk::tilef32::tile_f32_kernel<3, 2>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, vk::tilef32::Params)", "LN->fc1 (f32)"),
    ("void vk::tilef32::tile_f32_kernel<4, 0>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, vk::tilef32::Params)", "linear stage: fc2, out-projection (f32)"),
    ("void vk::tilef32::tile_f32_kernel<5, 0>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, vk::tilef32::Params)", "LN->qkv (f32)"),
    ("void vk::lnf32::ln_norm_f32_kernel(float const*, float const*, float const*, int, int, "
     "float, float*)", "LayerNorm forward rows (f32)"),
    ("void vk::wgradf32::wgrad_tf32_kernel(CUtensorMap_st, CUtensorMap_st, float*, float*, "
     "int, int, int, int)", "weight-gradient products (f32)"),
    # a parent's mma.sync product, which scripts/kernel_ab.py measures
    ("void vk::wgradf32::wgrad_f32_kernel(float const*, float const*, float*, float*, int, "
     "int, int, int)", "weight-gradient products (f32)"),
    ("void vk::wgrad::wgrad_reduce_kernel(float const*, float*, int, long)",
     "weight-gradient products"),
    ("void vk::lnrows::ln_bwd_rows_kernel<0, float>(vk::lnrows::BwdParams)",
     "megablock backward, MLP half"),
    ("void vk::lnrows::ln_bwd_rows_kernel<1, float>(vk::lnrows::BwdParams)",
     "megablock backward, LN1 half"),
    ("void vk::lnrows::ln_bwd_rows_kernel<0, __nv_bfloat16>(vk::lnrows::BwdParams)",
     "megablock backward, MLP half"),
    ("void vk::lnrows::ln_bwd_rows_kernel<1, __nv_bfloat16>(vk::lnrows::BwdParams)",
     "megablock backward, LN1 half"),
    ("void vk::lnrows::mask_rows_kernel<float>(float const*, float const*, float*, int, int)",
     "megablock backward, MLP half"),
    ("void vk::f32::flash_fwd_f32_kernel<64, 0>(vk::f32::FwdParams)", "flash forward (f32)"),
])
def test_the_f32_step_kernels_land_in_their_groups(symbol, label):
    assert chip_smoke._kernel_group(symbol, "auto") == label
