"""Hot-path markers shared with the JAX package's repro-lint analyzer (the
analyzer itself lints this package by path; its torch twins of R1/R2 wait
for the tooling slice)."""
from repro_torch.analysis.markers import hot_path  # noqa: F401
