"""Material models: GGX glossy coat over an Oren-Nayar base (layered BRDF).

Counterpart of `cornelis_tpu/materials.py`, quirks included (each biases
the image and is needed for parity; see that module's docstring):
GTR2 with a 1/(2 pi) normalization that returns 1 at almost-zero alpha^2;
Oren-Nayar taking cos(theta) from the world z component (the frame bug,
`frame_basis=None`) with C++'s max(0, NaN) == 0; the layered pdf as the
0.5-weighted average of layer pdfs; Burley remaps alpha = r^2 and
sigma = 0.5 r^2; a zero wi when the sampled half-vector is below the
surface; and the glossy pdf at half the sampler's true density.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .vec import PI, RGB, Basis, Vec3, dot, is_almost_zero, maximum, normalize, take
from .rng import hemisphere_pdf, hemisphere_sample_basis

Tensor = torch.Tensor


class MaterialParams(NamedTuple):
    """Per-ray StandardMaterial parameters."""

    albedo: RGB
    emission: RGB
    tint: RGB
    roughness: Tensor
    ior: Tensor


def gather_material_rows(table: Tensor, ids: Tensor) -> MaterialParams:
    """Rows of an (M, 11) material table by per-ray id."""
    rows = take(table, ids)
    col = lambda i: rows[:, i]
    return MaterialParams(
        albedo=RGB(col(0), col(1), col(2)),
        emission=RGB(col(3), col(4), col(5)),
        tint=RGB(col(6), col(7), col(8)),
        roughness=col(9),
        ior=col(10),
    )


def gather_materials(scene, ids: Tensor) -> MaterialParams:
    """The materials of a SceneArrays by per-ray id (materials.py:104-121
    of the JAX package). The fields are stacked into one (M, 11) table
    and gathered once (`take`), so the backward is one index_add_ into it;
    the JAX package's one-hot matmul backward (`_take_rows`) worked around
    the TPU's scatter and is not ported."""
    table = torch.stack(
        [*scene.mat_albedo, *scene.mat_emission, *scene.mat_tint, scene.mat_roughness,
         scene.mat_ior],
        dim=1,
    )
    return gather_material_rows(table, ids)


def emission(params: MaterialParams) -> RGB:
    """StandardMaterial::emission (Materials.hpp:333): position-independent."""
    return params.emission


# -- Burley roughness remaps (Materials.hpp:296-302) -----------------------


def glossy_alpha(roughness: Tensor) -> Tensor:
    return roughness * roughness


def diffuse_sigma(roughness: Tensor) -> Tensor:
    return torch.abs(0.5 * roughness * roughness)


# -- Microfacet building blocks (src/Materials.cpp:4-42) --------------------


def distribution_gtr2(cos_theta_h: Tensor, alpha: Tensor) -> Tensor:
    """GGX NDF, gamma=2 (Materials.cpp:16-26), in the cancellation-free
    form of the JAX package."""
    alpha2 = alpha * alpha
    c2 = cos_theta_h * cos_theta_h
    denom = (1.0 - c2) + alpha2 * c2
    d = (alpha2 / (2.0 * PI)) / maximum(denom * denom, 1e-18)
    return torch.where(is_almost_zero(alpha2), 1.0, d)


def lambda_tr(tan_theta: Tensor, alpha: Tensor) -> Tensor:
    """Smith lambda for Trowbridge-Reitz (Materials.cpp:28-32)."""
    inf = torch.isinf(tan_theta)
    at = torch.where(inf, 0.0, torch.abs(tan_theta) * alpha)
    lam = (-1.0 + torch.sqrt(1.0 + at * at)) * 0.5
    return torch.where(inf, 0.0, lam)


def shadow_masking_tr(tan_theta_i: Tensor, tan_theta_o: Tensor, alpha: Tensor) -> Tensor:
    """Smith G (Materials.cpp:34-36)."""
    return 1.0 / (1.0 + lambda_tr(tan_theta_i, alpha) + lambda_tr(tan_theta_o, alpha))


def schlick(cos_theta: Tensor, refidx1, refidx2) -> Tensor:
    """Schlick Fresnel (Materials.cpp:38-42)."""
    r0 = (refidx1 - refidx2) / (refidx1 + refidx2)
    r0 = r0 * r0
    m = 1.0 - cos_theta
    m2 = m * m
    return r0 + (1.0 - r0) * (m2 * m2 * m)


# -- Glossy (GGX) layer (Materials.hpp:120-198) -----------------------------


def glossy_eval(wi: Vec3, wo: Vec3, n: Vec3, tint: RGB, alpha: Tensor, ior: Tensor) -> RGB:
    """tint * F D G / (4 cosO cosI); black when either cosine is almost
    zero or the half-vector degenerates (Materials.hpp:130-154)."""
    cos_o = maximum(dot(wo, n), 0.0)
    cos_i = maximum(dot(wi, n), 0.0)
    dead = is_almost_zero(cos_o) | is_almost_zero(cos_i)

    sin_o = torch.sqrt(maximum(1.0 - cos_o * cos_o, 1e-12))
    sin_i = torch.sqrt(maximum(1.0 - cos_i * cos_i, 1e-12))

    h = normalize(wi + wo)
    h_zero = is_almost_zero(h.x) & is_almost_zero(h.y) & is_almost_zero(h.z)
    cos_h = maximum(dot(h, n), 0.0)

    safe_cos_o = torch.where(dead, 1.0, cos_o)
    safe_cos_i = torch.where(dead, 1.0, cos_i)

    d = distribution_gtr2(cos_h, alpha)
    g = shadow_masking_tr(sin_i / safe_cos_i, sin_o / safe_cos_o, alpha)
    f = schlick(cos_h, 1.0, ior)

    scale = torch.where(dead | h_zero, 0.0, f * d * g / (4.0 * safe_cos_o * safe_cos_i))
    return tint * scale


def glossy_sample(wo: Vec3, x0: Tensor, x1: Tensor, basis: Basis, alpha: Tensor) -> Vec3:
    """GGX half-vector sampling (Materials.hpp:156-175), reflected about
    h; the zero vector where h falls below the surface."""
    alpha2 = alpha * alpha
    a = 1.0 - x1
    b = 1.0 + (alpha2 - 1.0) * x1
    cos_h = torch.sqrt(maximum(a / b, 1e-12))
    sin_h = torch.sqrt(maximum(1.0 - cos_h * cos_h, 1e-12))
    phi = 2.0 * PI * x0

    h = normalize(
        basis.b * (sin_h * torch.cos(phi))
        + basis.t * (sin_h * torch.sin(phi))
        + basis.n * cos_h
    )
    below = dot(h, basis.n) < 0.0
    wi = normalize(h * (2.0 * dot(wo, h)) - wo)
    return Vec3(
        torch.where(below, 0.0, wi.x),
        torch.where(below, 0.0, wi.y),
        torch.where(below, 0.0, wi.z),
    )


def glossy_pdf(wi: Vec3, wo: Vec3, n: Vec3, alpha: Tensor) -> Tensor:
    """D |cos(theta_h)| / (4 wi.h), with the reference's fallbacks: 1 when
    cos(theta_h) ~ 0, D|cos| when wi.h ~ 0 (Materials.hpp:177-188)."""
    h = normalize(wi + wo)
    cos_h = maximum(dot(h, n), 0.0)
    d = distribution_gtr2(cos_h, alpha)
    pdf_h = d * torch.abs(cos_h)
    wi_dot_h = dot(wi, h)
    small = is_almost_zero(wi_dot_h)
    safe = torch.where(small, 1.0, wi_dot_h)
    pdf = torch.where(small, pdf_h, pdf_h / (4.0 * safe))
    return torch.where(is_almost_zero(cos_h), 1.0, pdf)


def glossy_sampler_density(wi: Vec3, wo: Vec3, n: Vec3, alpha: Tensor) -> Tensor:
    """The true density of glossy_sample: twice the reference pdf."""
    return 2.0 * glossy_pdf(wi, wo, n, alpha)


# -- Oren-Nayar diffuse layer (Materials.hpp:200-237) ------------------------


def oren_nayar_ab(sigma: Tensor):
    """A and B from sigma (Materials.hpp:206-209)."""
    sigma2 = sigma * sigma
    a = 1.0 - (sigma2 / (2.0 * (sigma2 + 0.333)))
    b = 0.45 * sigma2 / (sigma2 + 0.09)
    return a, b


def oren_nayar_eval(
    wi: Vec3, wo: Vec3, albedo: RGB, sigma: Tensor, frame_basis: Basis | None = None
) -> RGB:
    """Qualitative Oren-Nayar (Materials.hpp:211-228), acos-free. With
    frame_basis=None cos(theta) is the world z component (the reference's
    frame bug); pass the surface basis to evaluate in the tangent frame."""
    if frame_basis is not None:
        wi = Vec3(dot(wi, frame_basis.t), dot(wi, frame_basis.b), dot(wi, frame_basis.n))
        wo = Vec3(dot(wo, frame_basis.t), dot(wo, frame_basis.b), dot(wo, frame_basis.n))

    cos_i = wi.z
    cos_o = wo.z
    sin_i = torch.sqrt(maximum(1.0 - cos_i * cos_i, 1e-12))
    sin_o = torch.sqrt(maximum(1.0 - cos_o * cos_o, 1e-12))

    safe_sin_i = torch.where(sin_i > 0.0, sin_i, 1.0)
    safe_sin_o = torch.where(sin_o > 0.0, sin_o, 1.0)
    cphi_i = wi.x / safe_sin_i
    cphi_o = wo.x / safe_sin_o

    valid = (
        (sin_i > 0.0)
        & (sin_o > 0.0)
        & (torch.abs(cphi_i) <= 1.0)
        & (torch.abs(cphi_o) <= 1.0)
    )
    cos_dphi = cphi_i * cphi_o + torch.sqrt(
        maximum((1.0 - cphi_i * cphi_i) * (1.0 - cphi_o * cphi_o), 1e-12)
    )
    term = torch.where(valid, maximum(cos_dphi, 0.0), 0.0)

    a, b = oren_nayar_ab(sigma)
    scale = (a + b * term * sin_i * sin_o) / PI
    return albedo * scale


# -- Layered standard BRDF (Materials.hpp:245-306) ---------------------------


def layered_eval(wi: Vec3, wo: Vec3, n: Vec3, params: MaterialParams) -> RGB:
    """(1 - schlick(N.wi)) * diffuse + glossy (Materials.hpp:255-263)."""
    sigma = diffuse_sigma(params.roughness)
    alpha = glossy_alpha(params.roughness)
    d_f = oren_nayar_eval(wi, wo, params.albedo, sigma)
    g_f = glossy_eval(wi, wo, n, params.tint, alpha, params.ior)
    w = 1.0 - schlick(maximum(dot(n, wi), 0.0), 1.0, params.ior)
    return d_f * w + g_f


def layered_pdf(wi: Vec3, wo: Vec3, n: Vec3, params: MaterialParams) -> Tensor:
    """The reference's weighted-average pdf (Materials.hpp:265-277); the
    diffuse layer samples the uniform hemisphere."""
    alpha = glossy_alpha(params.roughness)
    return 0.5 * (hemisphere_pdf() + glossy_pdf(wi, wo, n, alpha))


def layered_pdf_true(wi: Vec3, wo: Vec3, n: Vec3, params: MaterialParams) -> Tensor:
    """The actual density of layered_sample's 50/50 mixture."""
    alpha = glossy_alpha(params.roughness)
    return 0.5 * (hemisphere_pdf() + glossy_sampler_density(wi, wo, n, alpha))


def layered_sample_direction(
    wo: Vec3, x0: Tensor, x1: Tensor, x2: Tensor, basis: Basis, params: MaterialParams
) -> Vec3:
    """The direction layered_sample draws: the diffuse layer's on x2 < 0.5,
    else the glossy one's."""
    alpha = glossy_alpha(params.roughness)
    choose_diffuse = x2 < 0.5

    wi_d = hemisphere_sample_basis(x0, x1, basis)
    wi_g = glossy_sample(wo, x0, x1, basis, alpha)
    return Vec3(
        torch.where(choose_diffuse, wi_d.x, wi_g.x),
        torch.where(choose_diffuse, wi_d.y, wi_g.y),
        torch.where(choose_diffuse, wi_d.z, wi_g.z),
    )


def layered_sample(
    wo: Vec3, x0: Tensor, x1: Tensor, x2: Tensor, basis: Basis, params: MaterialParams
):
    """Sample the layered BRDF (Materials.hpp:279-293): the diffuse layer on
    x2 < 0.5. Returns (wi, pdf, f) with the averaged layered pdf and the
    full layered eval at wi."""
    wi = layered_sample_direction(wo, x0, x1, x2, basis, params)
    pdf = layered_pdf(wi, wo, basis.n, params)
    f = layered_eval(wi, wo, basis.n, params)
    return wi, pdf, f
