"""Host-side data: CSR, blocked-ELL layouts, synthetic data, partitions."""
from repro_torch.data.partition import (Partition, equal_width_partition,
                                        imbalance, lpt_partition,
                                        make_partition)
from repro_torch.data.sparse import (BlockedEll, CSRMatrix, EllPair,
                                     build_shard_ell_pairs, ell_from_csr,
                                     hvp_tile_dtype, make_sparse_glm_data,
                                     shard_csrs_from_partition,
                                     stack_shard_ells)
from repro_torch.data.synthetic import REGIMES, make_glm_data, make_regime

__all__ = ["Partition", "equal_width_partition", "imbalance",
           "lpt_partition", "make_partition", "BlockedEll", "CSRMatrix",
           "EllPair", "build_shard_ell_pairs", "ell_from_csr",
           "hvp_tile_dtype", "make_sparse_glm_data",
           "shard_csrs_from_partition", "stack_shard_ells", "REGIMES",
           "make_glm_data", "make_regime"]
