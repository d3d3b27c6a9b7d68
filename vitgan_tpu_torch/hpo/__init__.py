from vitgan_tpu_torch.hpo.sweep import run_sweep, sample_search_space  # noqa: F401
