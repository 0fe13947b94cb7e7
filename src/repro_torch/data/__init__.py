"""Data pipeline (numpy): the synthetic LM, multimodal and retrieval
tasks, Dirichlet non-IID partitioning and the step-indexed client loader. Copies of the JAX
package's ``data/`` (which imports no JAX), so the port imports nothing of
it; with no fault plan they give the same batches bit for bit."""
from repro_torch.data.loader import ClientLoader
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import (SyntheticLM, SyntheticMultimodal,
                                        SyntheticRetrieval)
