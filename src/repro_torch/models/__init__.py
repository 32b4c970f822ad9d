"""LM-family models of the port: the dense GQA transformer's serving path
(``transformer.py``) and its building blocks (``common.py``)."""
