"""PCA embedding for the leiden_method='PCA' route.

Counterpart of infercnv_tpu/subcluster/pca.py (lines 1-133):
``variable_features_vst``, ``_gene_moments``, ``_clipped_z_moments``,
``_scale_and_project`` and ``pca_embed``.  Rows given as a tensor keep their
per-gene moments on its device (only [G] vectors come back to the host);
host rows take the reference's float64 numpy, accumulated over row blocks.  The VST trend is the port's
smoothing spline (utils/splines.py).  The projection is the reference's
randomised range finder with one power iteration: products with
``torch.matmul`` and QR and SVD with ``torch.linalg`` on the device (XLA's
dot, QR and SVD in the reference; no TPU kernel computes them).

The range finder's Gaussian [G, k] matrix comes from :func:`range_omega`, a
CPU ``torch.Generator`` seeded with ``seed`` whose draw then moves to the
device, so a card run and a CPU run project with the same matrix.  The
reference draws it with ``jax.random.normal(PRNGKey(seed), ...)``, which
torch cannot repeat; the tests hand that draw across through
``range_omega``.

reference: .leiden_seurat_preprocess_routine
(R/inferCNV_tumor_subclusters.R:699-723): Seurat ScaleData (per-gene z-score,
clipped at 10) followed by RunPCA(npcs=10) on the variable genes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from infercnv_tpu_torch.device import DeviceLike, resolve_device
from infercnv_tpu_torch.utils.splines import fit_smoothing_spline

#: Host rows' VST moments are accumulated over blocks of this many rows (a
#: whole-matrix pass would make [C, G] float64 temporaries: 18 GB for a
#: 266,666-cell group of the 1M-cell run).
VST_BLOCK_ROWS = 4096


def range_omega(seed: int, G: int, k: int) -> torch.Tensor:
    """The range finder's standard-normal [G, k] float32 matrix, on the CPU."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(seed))
    return torch.randn((G, k), generator=gen, dtype=torch.float32)


def _scale_and_project(x: torch.Tensor, seed: int, n_components: int,
                       scale_max: float) -> torch.Tensor:
    x = x.to(torch.float32)
    mu = x.mean(dim=0, keepdim=True)
    sd = x.std(dim=0, correction=1, keepdim=True)
    z = (x - mu) / torch.where(sd == 0, torch.ones_like(sd), sd)
    z = torch.clamp(z, max=scale_max)  # Seurat clips scaled values at scale.max=10
    C, G = z.shape
    k = min(n_components + 8, min(C, G))
    # randomized range finder: Y = Z (Z^T Omega), one power iteration
    omega = range_omega(seed, G, k).to(z.device)
    Y = z @ omega
    Y = z @ (z.T @ Y)
    Q, _ = torch.linalg.qr(Y)
    B = Q.T @ z                       # [k, G]
    _, _s, Vt = torch.linalg.svd(B, full_matrices=False)
    return z @ Vt[:n_components].T    # [C, n_components]


def _gene_moments(x: torch.Tensor):
    """Per-gene mean and ddof-1 variance of a device [C, G] matrix (f32)."""
    x = x.to(torch.float32)
    C = x.shape[0]
    mu = x.mean(dim=0)
    var = ((x - mu[None, :]) ** 2).sum(dim=0) / np.float32(C - 1)
    return mu, var


def _clipped_z_moments(x: torch.Tensor, mu: torch.Tensor, inv_sd: torch.Tensor,
                       clip: float):
    """sum and sum-of-squares per gene of min((x - mu) * inv_sd, clip)."""
    zb = torch.clamp((x.to(torch.float32) - mu[None, :]) * inv_sd[None, :], max=clip)
    return zb.sum(dim=0), (zb * zb).sum(dim=0)


def vst_standardized_variance(x_cg) -> Optional[np.ndarray]:
    """Each gene's variance after standardising with the VST trend's
    expected sd (clipped at sqrt(N)), as float64 [G]; None when fewer than
    10 genes vary (the selection then keeps every gene)."""
    on_device = torch.is_tensor(x_cg)
    x = x_cg if on_device else np.asarray(x_cg)
    C, G = x.shape
    if on_device:
        # every statistic reduces to per-gene vectors: compute them on the
        # device and bring back [G] vectors only
        mu_d, var_d = _gene_moments(x)
        mu = mu_d.cpu().numpy().astype(np.float64)
        var = var_d.cpu().numpy().astype(np.float64)
    else:
        # two passes over row blocks in float64: the mean, then the
        # squared deviations from it (numpy's var, without its [C, G]
        # float64 temporary of x - mean)
        total = np.zeros(G)
        for b in range(0, C, VST_BLOCK_ROWS):
            total += x[b:b + VST_BLOCK_ROWS].sum(axis=0, dtype=np.float64)
        mu = total / C
        sq = np.zeros(G)
        for b in range(0, C, VST_BLOCK_ROWS):
            d = x[b:b + VST_BLOCK_ROWS] - mu[None, :]
            sq += np.einsum("ij,ij->j", d, d)
        var = sq / (C - 1)
    ok = var > 0
    if ok.sum() < 10:
        return None
    spline = fit_smoothing_spline(np.log10(mu[ok] + 1e-12), np.log10(var[ok]))
    exp_sd = np.sqrt(10.0 ** spline.predict(np.log10(np.maximum(mu, 1e-12))))
    exp_sd = np.maximum(exp_sd, 1e-12)
    clip = np.sqrt(C)
    if on_device:
        zsum_d, zsq_d = _clipped_z_moments(
            x, torch.as_tensor(mu.astype(np.float32), device=x.device),
            torch.as_tensor((1.0 / exp_sd).astype(np.float32), device=x.device),
            float(np.float32(clip)))
        zsum = zsum_d.cpu().numpy().astype(np.float64)
        zsq = zsq_d.cpu().numpy().astype(np.float64)
    else:
        # running moments of the clipped z, accumulated over row chunks (a
        # full-size standardized copy would be several [C, G] float64
        # temporaries)
        zsum = np.zeros(G)
        zsq = np.zeros(G)
        inv_sd = (1.0 / exp_sd)[None, :]
        for b in range(0, C, VST_BLOCK_ROWS):
            zb = np.minimum((x[b:b + VST_BLOCK_ROWS] - mu[None, :]) * inv_sd, clip)
            zsum += zb.sum(axis=0, dtype=np.float64)
            zsq += np.einsum("ij,ij->j", zb, zb)
    zmean = zsum / C
    std_var = (zsq - C * zmean * zmean) / (C - 1)
    std_var[~ok] = 0.0
    return std_var


def variable_features_vst(x_cg, n_features: int = 2000) -> np.ndarray:
    """Seurat FindVariableFeatures(selection.method='vst') analogue
    (the reference calls it before RunPCA,
    R/inferCNV_tumor_subclusters.R:702-709): fit a smooth trend of
    log10(variance) ~ log10(mean), standardize values with the expected sd
    clipped at sqrt(N), rank genes by standardized variance.

    Returns indices of the top `n_features` genes."""
    G = x_cg.shape[1]
    if G <= n_features:
        return np.arange(G)
    std_var = vst_standardized_variance(x_cg)
    if std_var is None:
        return np.arange(G)
    return np.sort(np.argsort(-std_var, kind="stable")[:n_features])


def pca_embed(x_cg, n_components: int = 10, scale_max: float = 10.0,
              seed: int = 0, use_variable_features: bool = True,
              n_features: int = 2000, upload_dtype=None,
              device: DeviceLike = None) -> torch.Tensor:
    """[C, n_components] float32 embedding on the device.  x_cg is a tensor
    (kept on its device when `device` is None) or host rows, moved to
    `device`.  upload_dtype: move host rows in this dtype (float16 when the
    matrix already carries f16-quantized values from
    engine_transfer_dtype='float16': the cast is then lossless and the copy
    halves)."""
    if use_variable_features and x_cg.shape[1] > n_features:
        cols = variable_features_vst(x_cg, n_features)
        x_cg = (x_cg[:, torch.as_tensor(cols, device=x_cg.device)]
                if torch.is_tensor(x_cg) else x_cg[:, cols])
    n_components = min(n_components, min(x_cg.shape) - 1)
    if torch.is_tensor(x_cg) and device is None:
        dev = x_cg.device
    else:
        dev = resolve_device(device)
    if n_components < 1:
        return torch.zeros((x_cg.shape[0], 1), dtype=torch.float32, device=dev)
    if not torch.is_tensor(x_cg):
        host = np.ascontiguousarray(x_cg, dtype=upload_dtype or np.float32)
        x_cg = torch.from_numpy(host)
    return _scale_and_project(x_cg.to(dev), seed, n_components, scale_max)
