"""K2: all-prefix pairwise TLB table (replaces ``repro/kernels/pairwise_tlb``)."""
