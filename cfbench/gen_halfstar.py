"""Seeded half-star rating data: ``cfbench.gen``'s latent generator with
its ratings rounded to a finer grid, ``round(raw / step) · step`` within
[rating_min, rating_max] (MovieLens-25M: step 0.5, 0.5-5.0).

The grid comes from ``gen.generate`` run at 1 / step times the scale:
the global mean, both bias deviations, the affinity scale, the noise and
the rating range all multiplied by s = 1 / step, a power of two.  Every
f32 product and sum of the latent model is then exactly s times its value
at scale 1 (a power of two scales a float's rounding with it), so the
integer ratings it rounds to are round(s · raw), and dividing the matrix
by s in place gives the half stars.  The draws are the same as at scale 1:
the same items rated by the same users, the same tastes; the matrix is
made on the device in ``gen``'s user blocks, with no copy of it.
"""

from __future__ import annotations

import dataclasses

import torch

from cfbench import gen

# the latent model's settings that are ratings (or deviations of them)
_SCALED = ("global_mean", "user_bias_std", "item_bias_std", "noise_std",
           "affinity_scale")


@dataclasses.dataclass
class HalfStarRatings(gen.Ratings):
    """A generated deployment rated on the grid of ``model["rating_step"]``."""

    def rating(self, raw):
        m = self.model
        step = m["rating_step"]
        return (torch.round(raw / step) * step).clamp(m["rating_min"],
                                                      m["rating_max"])


def grid_scale(step: float) -> int:
    """1 / ``step``, which must be a power of two no less than 1."""
    scale = round(1.0 / step)
    if scale < 1 or scale & (scale - 1) or scale * step != 1.0:
        raise ValueError(f"rating_step {step} is not 1 / 2^j")
    return scale


def generate(cfg: dict, seed: int, device) -> HalfStarRatings:
    """The configuration's rating matrix for ``seed`` on its
    ``rating_step`` grid, made on ``device``."""
    scale = grid_scale(cfg["rating_step"])
    scaled = dict(cfg, assumed=dict(cfg["assumed"]),
                  rating_min=cfg["rating_min"] * scale,
                  rating_max=cfg["rating_max"] * scale)
    for key in _SCALED:
        scaled["assumed"][key] = cfg["assumed"][key] * scale
    data = gen.generate(scaled, seed, device)
    data.matrix.mul_(1.0 / scale)
    model = dict(gen.model_settings(cfg), rating_step=cfg["rating_step"])
    return HalfStarRatings(
        matrix=data.matrix, taste_u=data.taste_u, taste_i=data.taste_i,
        bias_u=data.bias_u / scale, bias_i=data.bias_i / scale,
        log_pop=data.log_pop, counts=data.counts, model=model)
