"""Models of the port: the LM family's dense GQA transformer serving path
(``transformer.py``), the recsys CTR models' serving and retrieval steps
(``dlrm.py``, ``fm.py``, ``xdeepfm.py`` over ``embedding.py``'s fused
tables), the E(n)-equivariant GNN (``egnn.py``) and their building
blocks (``common.py``)."""
