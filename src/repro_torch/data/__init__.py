"""Data pipeline (numpy): the synthetic LM, multimodal and retrieval
tasks, Dirichlet non-IID partitioning, the step-indexed client loader and
its background prefetcher. Copies of the JAX package's ``data/`` (which
imports no JAX), so the port imports nothing of it; they give the same
batches bit for bit, under the same fault plan too."""
from repro_torch.data.loader import ClientLoader
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.prefetch import PrefetchLoader
from repro_torch.data.synthetic import (SyntheticLM, SyntheticMultimodal,
                                        SyntheticRetrieval)
