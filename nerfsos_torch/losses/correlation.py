"""The collaborative contrastive correlation losses of NeRF-SOS.

Port of ``nerfsos_tpu/losses/correlation.py`` (reference ``utils/image.py``):

- :class:`CorrelationLoss` (appearance): a hinge between the DINO patch
  feature correlation (no-grad, pointwise recentred) and the rendered
  semantic-code correlation over 11 x 11 grid-sampled coordinates; the SOS
  step's four evaluations (self and negative, coarse and fine heads) in one
  batch by :meth:`CorrelationLoss.pair_heads`;
- :class:`GeoCorrelationLoss` (geometry): rendered depth back-projected to
  3-D points, the clamped inverse-L1 kernel on both sides, the whole patch
  against itself, on kernel K7 (``ops/flash_corr.py``): one mean
  (:meth:`GeoCorrelationLoss.helper_mean`, K7b/K7c), two heads on one sweep
  (:meth:`GeoCorrelationLoss.helper_mean_pair`, K7d/K7e), the SOS step's
  four evaluations (:meth:`GeoCorrelationLoss.quad`, K7f/K7g);
- :func:`nerf_contrastive`: the min/max CLS cosine contrast.

Randomness is explicit: coordinates and random negatives are drawn from a
``torch.Generator`` (:func:`draw_pair_coords`, :meth:`CorrelationLoss.
negative_index`) or given by the caller. The negatives are a uniform
permutation with ``rand_neg``, a permutation without fixed points
(:func:`super_perm`) when there is no similarity matrix, and the CLS
similarity matrix's argmin otherwise.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from nerfsos_torch.ops.flash_corr import (flash_geo_pair_quad, geo_helper_mean,
                                          geo_helper_mean_pair)
from nerfsos_torch.ops.grid_sample import grid_sample_bilinear


def _safe_norm(x: torch.Tensor, dim: int, eps: float) -> torch.Tensor:
    """``||x||`` along ``dim`` with a finite gradient at 0: rays whose sigmas
    are all negative composite to exactly zero semantic vectors."""
    return torch.sqrt(torch.clamp(torch.sum(x * x, dim=dim, keepdim=True), min=eps * eps))


def get_similarity_matrix(x: torch.Tensor) -> torch.Tensor:
    """Pairwise CLS cosine similarity ``[B, B]``."""
    xn = x / _safe_norm(x, -1, 1e-8)
    return xn @ xn.T


def super_perm(generator: Optional[torch.Generator], size: int,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """A random permutation without fixed points."""
    perm = torch.randperm(size, generator=generator, device=device)
    perm = torch.where(perm == torch.arange(size, device=perm.device), perm + 1, perm)
    return perm % size


def _norm(t: torch.Tensor) -> torch.Tensor:
    """``F.normalize(dim=1, eps=1e-10)`` with a finite gradient at 0."""
    return t / _safe_norm(t, 1, 1e-10)


def _pointwise_recenter(fd: torch.Tensor) -> torch.Tensor:
    """fd minus its mean over the last two dims, then recentred to its old
    global mean."""
    old = fd.mean()
    fd = fd - fd.mean(dim=(3, 4), keepdim=True)
    return fd - fd.mean() + old


def draw_pair_coords(generator: Optional[torch.Generator], batch: int, samples: int,
                     device: torch.device) -> torch.Tensor:
    """The coordinates of :meth:`CorrelationLoss.pair_heads` ``[4 B, F, F, 2]``
    in [-1, 1): the coarse and fine heads' own-patch draws, then their
    negative-patch draws."""
    return torch.rand((4 * batch, samples, samples, 2), generator=generator,
                      device=device) * 2.0 - 1.0


@dataclasses.dataclass(frozen=True)
class CorrelationLoss:
    """Appearance correlation loss. ``from_params`` order: (self_shift,
    self_weight, neg_shift, neg_weight)."""

    self_shift: float = 0.18
    self_weight: float = 0.67
    neg_shift: float = 0.46
    neg_weight: float = 0.63
    feature_samples: int = 11
    zero_clamp: bool = True
    stabilize: bool = False
    pointwise: bool = True
    use_sim_matrix: bool = True
    rand_neg: bool = False

    @classmethod
    def from_params(cls, params: Sequence[float], **kw) -> "CorrelationLoss":
        s = [float(x) for x in params]
        return cls(self_shift=s[0], self_weight=s[1], neg_shift=s[2], neg_weight=s[3], **kw)

    def tensor_correlation(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``einsum('nchw,ncij->nhwij')``."""
        return torch.einsum("nchw,ncij->nhwij", a, b)

    def sample(self, t: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
        """grid_sample with the reference's ``coords.permute(0, 2, 1, 3)``."""
        return grid_sample_bilinear(t, coords.permute(0, 2, 1, 3))

    def _clamp_min(self) -> float:
        return 0.0 if self.zero_clamp else -9999.0

    def feat_transform(self, t: torch.Tensor) -> torch.Tensor:
        """The appearance loss L2-normalises the DINO features per pixel."""
        return _norm(t)

    def _cd(self, c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
        cd = self.tensor_correlation(_norm(c1), _norm(c2))
        return torch.clamp(cd, self._clamp_min(), 0.8 if self.stabilize else None)

    def helper(self, f1, f2, c1, c2, shift: float) -> torch.Tensor:
        with torch.no_grad():
            fd = self.tensor_correlation(self.feat_transform(f1), self.feat_transform(f2))
            if self.pointwise:
                fd = _pointwise_recenter(fd)
        return -self._cd(c1, c2) * (fd - shift)

    def helper_mean(self, f1, f2, c1, c2, shift: float) -> torch.Tensor:
        """``helper(...).mean()``, the scalar the loss takes."""
        return self.helper(f1, f2, c1, c2, shift).mean()

    def _helper_means_grouped(self, f1, f2, c1, c2, shifts: Sequence[float]) -> torch.Tensor:
        """``[helper(f1_g, f2_g, c1_g, c2_g, shifts[g]).mean() for g]`` over G
        groups stacked on the batch axis, the recentering statistics and the
        mean taken per group."""
        G = len(shifts)
        with torch.no_grad():
            fd = self.tensor_correlation(self.feat_transform(f1), self.feat_transform(f2))
            fd = fd.reshape((G, -1) + fd.shape[1:])  # [G, B, H, W, I, J]
            if self.pointwise:
                old = fd.reshape(G, -1).mean(dim=1)
                fd = fd - fd.mean(dim=(4, 5), keepdim=True)
                fd = fd + (old - fd.reshape(G, -1).mean(dim=1)).reshape((G,) + (1,) * 5)
        cd = self._cd(c1, c2).reshape(fd.shape)
        sh = fd.new_tensor(shifts).reshape((G,) + (1,) * 5)
        return (-cd * (fd - sh)).reshape(G, -1).mean(dim=1)

    def negative_index(self, generator: Optional[torch.Generator], batch: int,
                       sim_matrix: Optional[torch.Tensor]) -> torch.Tensor:
        """The negative patch of each patch: a uniform permutation drawn from
        ``generator`` with ``rand_neg``, :func:`super_perm` when there is no
        similarity matrix, else the least similar patch (the argmin). The
        SOS step always passes its CLS similarity matrix, as the JAX step
        does, so ``use_sim_matrix`` changes nothing there."""
        if self.rand_neg:
            device = None if generator is None else generator.device
            return torch.randperm(batch, generator=generator, device=device)
        if sim_matrix is None:
            return super_perm(generator, batch, None if generator is None else generator.device)
        return torch.argmin(sim_matrix, dim=0)

    def single(self, coords: torch.Tensor, neg_idx: torch.Tensor, orig_feats: torch.Tensor,
               orig_code: torch.Tensor) -> torch.Tensor:
        """One head's loss ``neg_weight * neg + self_weight * self`` from DINO
        features ``[B, C, hf, wf]`` and codes ``[B, sem, P, P]``, with
        ``coords [2 B, F, F, 2]`` (the own patches', then the negatives') and
        the negatives ``neg_idx [B]``."""
        coords1, coords2 = torch.chunk(coords, 2)
        feats, code = self.sample(orig_feats, coords1), self.sample(orig_code, coords1)
        neg_feats = self.sample(orig_feats[neg_idx], coords2)
        neg_code = self.sample(orig_code[neg_idx], coords2)
        return (self.neg_weight * self.helper_mean(feats, neg_feats, code, neg_code,
                                                   self.neg_shift)
                + self.self_weight * self.helper_mean(feats, feats, code, code, self.self_shift))

    def __call__(self, generator: Optional[torch.Generator], orig_feats: torch.Tensor,
                 orig_code: torch.Tensor, sim_matrix: Optional[torch.Tensor]) -> torch.Tensor:
        """:meth:`single` with its coordinates, then its negatives, drawn from
        ``generator`` (the JAX loss's ``k_c1``, ``k_c2``, ``k_neg``)."""
        B = orig_feats.shape[0]
        device = orig_feats.device
        coords = torch.rand((2 * B, self.feature_samples, self.feature_samples, 2),
                            generator=generator, device=device) * 2.0 - 1.0
        return self.single(coords, self.negative_index(generator, B, sim_matrix), orig_feats,
                           orig_code)

    def pair_heads(self, coords: torch.Tensor, orig_feats: torch.Tensor, code0: torch.Tensor,
                   code1: torch.Tensor, sim_matrix: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The coarse and fine heads' losses ``neg_weight * neg + self_weight
        * self`` from DINO features ``[B, C, hf, wf]`` and codes ``[B, sem, P,
        P]``, with ``coords [4 B, F, F, 2]`` (:func:`draw_pair_coords`) and the
        similarity matrix's argmin as the negatives of both."""
        neg_idx = torch.argmin(sim_matrix, dim=0)
        featn = orig_feats[neg_idx]
        fs = self.sample(torch.cat([orig_feats, orig_feats, featn, featn]), coords)
        cs = self.sample(torch.cat([code0, code1, code0[neg_idx], code1[neg_idx]]), coords)
        fa, fb, nfa, nfb = torch.chunk(fs, 4)
        ca, cb, nca, ncb = torch.chunk(cs, 4)
        m = self._helper_means_grouped(
            torch.cat([fa, fb, fa, fb]), torch.cat([fa, fb, nfa, nfb]),
            torch.cat([ca, cb, ca, cb]), torch.cat([ca, cb, nca, ncb]),
            (self.self_shift, self.self_shift, self.neg_shift, self.neg_shift))
        return (self.neg_weight * m[2] + self.self_weight * m[0],
                self.neg_weight * m[3] + self.self_weight * m[1])


@dataclasses.dataclass(frozen=True)
class GeoCorrelationLoss(CorrelationLoss):
    """Geometry correlation loss over whole patches; ``from_params`` order
    as the appearance loss's."""

    self_shift: float = 3.0
    neg_shift: float = 10.0
    max_depth: float = 15.0

    def feat_transform(self, t: torch.Tensor) -> torch.Tensor:
        """Identity: the kernel takes raw XYZ points."""
        return t

    def tensor_correlation(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Clamped inverse-L1 kernel ``[N, H, W, I, J]``."""
        ret = torch.abs(a[:, :, :, :, None, None] - b[:, :, None, None, :, :]).sum(1).abs()
        return torch.clamp(1.0 / (ret + 5e-2), max=self.max_depth)

    @staticmethod
    def depth2pts(depth: torch.Tensor, ray_o: torch.Tensor, ray_d: torch.Tensor) -> torch.Tensor:
        """XYZ = o + d * depth, all ``[B, 3, P, P]`` (depth ``[B, 1, P, P]``)."""
        return ray_o + ray_d * depth

    def _filtered_points(self, depth: torch.Tensor, ray_o: torch.Tensor,
                         ray_d: torch.Tensor) -> torch.Tensor:
        """Depths over max_depth take the batch's largest depth under it."""
        under = torch.where(depth < self.max_depth, depth, torch.full_like(depth, -torch.inf))
        depth = torch.where(depth > self.max_depth, under.max(), depth)
        return self.depth2pts(depth, ray_o, ray_d)

    def _check_form(self) -> None:
        if not (self.pointwise and self.zero_clamp and not self.stabilize):
            raise NotImplementedError("the geometry loss runs on K7, which takes the pointwise, "
                                      "zero-clamped, unstabilised form only")

    def helper_mean(self, f1, f2, c1, c2, shift: float) -> torch.Tensor:
        """``helper(...).mean()`` on K7b/K7c (points ``[B, 3, P, P]``)."""
        self._check_form()
        return geo_helper_mean(f1, f2, _norm(c1), _norm(c2), shift, self.max_depth)

    def helper_mean_pair(self, f1, f2, c1a, c2a, c1b, c2b, shift: float
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Two helper means over the same points, heads a and b, on K7d/K7e."""
        self._check_form()
        return geo_helper_mean_pair(f1, f2, _norm(c1a), _norm(c2a), _norm(c1b), _norm(c2b),
                                    shift, self.max_depth)

    def single(self, pts: torch.Tensor, code: torch.Tensor, neg_idx: torch.Tensor
               ) -> torch.Tensor:
        """One head's loss ``neg_weight * neg + self_weight * self`` from the
        filtered points and the codes ``[B, sem, P, P]``, with the negatives
        ``neg_idx [B]`` (the JAX step's ``geo_single``)."""
        return (self.neg_weight * self.helper_mean(pts, pts[neg_idx], code, code[neg_idx],
                                                   self.neg_shift)
                + self.self_weight * self.helper_mean(pts, pts, code, code, self.self_shift))

    def __call__(self, generator: Optional[torch.Generator], depth: torch.Tensor,
                 orig_code: torch.Tensor, ray_o: torch.Tensor, ray_d: torch.Tensor,
                 sim_matrix: Optional[torch.Tensor]) -> torch.Tensor:
        """One head's loss from the depth ``[B, 1, P, P]`` and the rays
        ``[B, 3, P, P]``, the negatives drawn from ``generator``."""
        pts = self._filtered_points(depth, ray_o, ray_d)
        return self.single(pts, orig_code, self.negative_index(generator, pts.shape[0],
                                                               sim_matrix))

    def pair(self, generator: Optional[torch.Generator], depth: torch.Tensor,
             code0: torch.Tensor, code1: torch.Tensor, ray_o: torch.Tensor, ray_d: torch.Tensor,
             sim_matrix: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both heads' losses over the same depth: two :meth:`__call__`s (two
        draws of negatives, the coarse head's first) when the negatives are
        random, else the four means on K7f/K7g with the argmin shared."""
        if self.rand_neg or sim_matrix is None:
            return (self(generator, depth, code0, ray_o, ray_d, sim_matrix),
                    self(generator, depth, code1, ray_o, ray_d, sim_matrix))
        pts = self._filtered_points(depth, ray_o, ray_d)
        neg = torch.argmin(sim_matrix, dim=0)
        n0, n1, s0, s1 = self.quad(pts, pts[neg], code0, code0[neg], code1, code1[neg])
        return (self.neg_weight * n0 + self.self_weight * s0,
                self.neg_weight * n1 + self.self_weight * s1)

    def quad(self, feats, neg_feats, c0, c0_neg, c1, c1_neg
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """(neg coarse, neg fine, self coarse, self fine) helper means on K7f/K7g."""
        self._check_form()
        return flash_geo_pair_quad(feats, neg_feats, _norm(c0), _norm(c0_neg), _norm(c1),
                                   _norm(c1_neg), self.neg_shift, self.self_shift, self.max_depth)


def nerf_contrastive(embeddings: torch.Tensor) -> torch.Tensor:
    """``-log(max / (max + min))`` over the off-diagonal CLS cosine similarities."""
    B = embeddings.shape[0]
    sim = get_similarity_matrix(embeddings)
    off = ~torch.eye(B, dtype=torch.bool, device=sim.device)
    lo = torch.min(torch.where(off, sim, torch.full_like(sim, torch.inf)))
    hi = torch.max(torch.where(off, sim, torch.full_like(sim, -torch.inf)))
    return -torch.log(hi / (hi + lo))
