"""The collaborative contrastive correlation losses of NeRF-SOS.

Port of ``nerfsos_tpu/losses/correlation.py`` (reference ``utils/image.py``):

- :class:`CorrelationLoss` (appearance): a hinge between the DINO patch
  feature correlation (no-grad, pointwise recentred) and the rendered
  semantic-code correlation over 11 x 11 grid-sampled coordinates; the SOS
  step's four evaluations (self and negative, coarse and fine heads) in one
  batch by :meth:`CorrelationLoss.pair_heads`;
- :class:`GeoCorrelationLoss` (geometry): rendered depth back-projected to
  3-D points, the clamped inverse-L1 kernel on both sides, the whole patch
  against itself; the four evaluations of the SOS step run on kernel K7
  (:meth:`GeoCorrelationLoss.quad`, ``ops/flash_corr.py``);
- :func:`nerf_contrastive`: the min/max CLS cosine contrast.

Randomness is explicit: the appearance loss's coordinates are drawn from a
``torch.Generator`` (:func:`draw_pair_coords`) or given by the caller; the
negatives come from the CLS similarity matrix's argmin. The random-negative
modes (``rand_neg``, ``super_perm`` without a similarity matrix) are not on
the ported path.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from nerfsos_torch.ops.flash_corr import flash_geo_pair_quad
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

    def negative_index(self, sim_matrix: torch.Tensor) -> torch.Tensor:
        """The least similar patch of each patch (the CLS similarity argmin)."""
        if self.rand_neg or not self.use_sim_matrix:
            raise NotImplementedError("random negatives (rand_neg, or no use_sim_matrix) are not "
                                      "ported: they need the single-head geometry kernels K7b/K7c")
        return torch.argmin(sim_matrix, dim=0)

    def pair_heads(self, coords: torch.Tensor, orig_feats: torch.Tensor, code0: torch.Tensor,
                   code1: torch.Tensor, sim_matrix: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The coarse and fine heads' losses ``neg_weight * neg + self_weight
        * self`` from DINO features ``[B, C, hf, wf]`` and codes ``[B, sem, P,
        P]``, with ``coords [4 B, F, F, 2]`` (:func:`draw_pair_coords`)."""
        neg_idx = self.negative_index(sim_matrix)
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

    def quad(self, feats, neg_feats, c0, c0_neg, c1, c1_neg
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """(neg coarse, neg fine, self coarse, self fine) helper means on K7."""
        if not (self.pointwise and self.zero_clamp and not self.stabilize):
            raise NotImplementedError("the geometry loss runs on K7, which takes the pointwise, "
                                      "zero-clamped, unstabilised form only")
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
