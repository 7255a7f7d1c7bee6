"""The benchmark of graph_learn_tpu_torch: sampled 2-hop GNN training at
ogbn-products' size on one card.  ``run.py`` runs one cell once; the
cells, configurations and per-layer metrics are files found by name
(``catalog.py``)."""
