"""Plain reference of the CF engine's exact paths: Pearson top-k neighbors
(:mod:`.topk`) and the top-n recommend (:mod:`.recommend`), written from
the paper's definitions in plain PyTorch.  Nothing here imports the port
or takes anything it made: the reference recomputes user statistics and
similarities from the rating matrix that the benchmark made.

``dtype`` selects the precision of the arithmetic after the exact integer
sums: ``torch.float32`` is the reference, ``torch.bfloat16`` the control
(the nearest precision below the configuration's f32 scores).
"""
