"""Host-side data: CSR, blocked-ELL layouts, the libsvm readers, synthetic
data, partitions."""
from repro_torch.data.libsvm import load_libsvm, save_libsvm
from repro_torch.data.partition import (Partition, equal_width_partition,
                                        imbalance, lpt_partition,
                                        make_partition)
from repro_torch.data.sparse import (BlockedEll, CSRMatrix, EllPair,
                                     build_shard_ell_pairs, ell_from_csr,
                                     hvp_tile_dtype, iter_libsvm_chunks,
                                     load_libsvm_sparse,
                                     make_sparse_glm_data,
                                     shard_csrs_from_partition,
                                     stack_shard_ells, truncate_features)
from repro_torch.data.synthetic import REGIMES, make_glm_data, make_regime

__all__ = ["Partition", "equal_width_partition", "imbalance",
           "lpt_partition", "make_partition", "BlockedEll", "CSRMatrix",
           "EllPair", "build_shard_ell_pairs", "ell_from_csr",
           "hvp_tile_dtype", "iter_libsvm_chunks", "load_libsvm",
           "load_libsvm_sparse", "make_sparse_glm_data", "save_libsvm",
           "shard_csrs_from_partition", "stack_shard_ells",
           "truncate_features", "REGIMES", "make_glm_data", "make_regime"]
