"""K3 1-NN, K4 DBSCAN eps-ball and K5 Gaussian-KDE pairwise reductions
(replace the kernels of ``repro/kernels/pairwise_reduce`` other than the
split variants)."""
