"""Models of the port: the LM family's dense GQA transformer serving path
(``transformer.py``), the recsys CTR models' serving and retrieval steps
(``dlrm.py``, ``fm.py``, ``xdeepfm.py`` over ``embedding.py``'s fused
tables) and their building blocks (``common.py``)."""
