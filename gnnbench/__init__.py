"""The benchmark of graph_learn_tpu_torch: sampled GNN training at
ogbn-products' size on one card, at the depth of each workload's fanout.
``run.py`` runs one cell once; the cells, configurations, models, their
references and per-layer metrics are files found by name
(``catalog.py``)."""
