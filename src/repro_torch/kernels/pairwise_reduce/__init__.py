"""K3: 1-NN pairwise reduction (replaces the kNN kernel of
``repro/kernels/pairwise_reduce``; DBSCAN and KDE come in a later slice)."""
