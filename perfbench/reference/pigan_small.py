"""Plain reference of the configuration ``pigan_small``: π-GAN (Chan et al.,
arXiv:2012.00926) as the configuration runs it.

Generator, for z (B, 128):
  * mapping: z/‖z‖, three Dense + LeakyReLU(0.2) at 128·L wide, then Dense
    heads to γ and β of each of the L = 6 FiLM'd sine layers (B, L, H); a
    second mapping of width 128 gives the colour layer's γ, β;
  * cameras: an integer azimuth in [220, 320) degrees, elevation 0, an
    orthographic camera at distance 0.1 looking at the origin (pytorch3d's
    look-at); one ray per pixel centre, from the near plane (z = 1) along
    the view axis with length 99;
  * coarse depths: 16 even depths in [0.1, 1.0], each jittered uniformly in
    its bin; fine depths: 16 inverse-CDF samples of the coarse weights
    (interior bins, +1e-5) with uniform draws, sorted together with the
    coarse ones; the coarse pass carries no gradient;
  * field at a point x with unit view direction d: h = x, then for each of
    the L layers h ← sin(w0·(γ_l·(h W_l + b_l) + β_l)), w0 = 30 for the
    first and 1 after, one more layer sin(h W + b); σ = sigmoid(h·w_α + b_α);
    colour = sigmoid(Dense(sin(γ_c·([h, d] W_c + b_c) + β_c)));
  * emission–absorption: w_k = d_k Π_{i<k}(1 + 1e-10 − d_i), RGB = Σ w_k c_k,
    opacity 1 − Π(1 − d_k).
Discriminator (progressive, CoordConv: two coordinate channels in [−1, 1]
appended to every convolution's input): entry from_rgb at the training
resolution S (1×1 + LeakyReLU), blocks S → 4 of (3×3, LeakyReLU, 3×3,
LeakyReLU, AvgPool 2) + a 1×1 stride-2 shortcut, widths 64, 128, 256, 400,
400, 400; the block below S fades in from_rgb of the image at half size
(every other pixel) with the weight α; a 2×2 convolution to one logit.
Losses: D: mean(relu(1 + D(real)) + relu(1 − D(fake))) + reg ·
mean‖∇ₓΣD(x)‖² on the reals, read from the images by border-clamped
bilinear sampling at the ray grid; G: mean(D(fake)). α falls by 1/10000
per micro-batch from 1 after each growth. Adam (β 0, 0.9; ε 1e-8), the
learning rates falling linearly over 10,000 updates to a quarter (D) and a
fifth (G).

Weights: drawn from one CPU generator seeded with the seed in the order
the modules are built (G, then D): SIREN layers U(±1/3) for the first and
U(±√(6/n)/w0) after, their biases alike; Dense layers LeCun's truncated
normal with zero bias; convolutions N(0, 0.02) with zero bias. Draws on the
device: z from seed + 1, views from seed + 2, depth jitter from seed + 3,
fine samples from seed + 4.

Everything computes in float32 (TF32 off), with the exact sine; with
``quant`` every product in float8 (plain.Numerics).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from . import plain

Z_NEAR, Z_FAR = 1.0, 100.0
W0_FIRST, W0 = 30.0, 1.0
MAX_CHAN = 400


def _lecun(fan_in, fan_out, gen):
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    w = torch.empty(fan_out, fan_in)
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)
    return nn.Parameter(w)


class Dense(nn.Module):
    def __init__(self, num, fin, fout, gen):
        super().__init__()
        self.num = num
        self.weight = _lecun(fin, fout, gen)
        self.bias = nn.Parameter(torch.zeros(fout))

    def forward(self, x):
        return self.num.linear(x, self.weight, self.bias)


class Siren(nn.Module):
    """sin(w0·(γ·(x W + b) + β)); W is (in, out)."""

    def __init__(self, num, fin, fout, w0, first, gen):
        super().__init__()
        self.num, self.w0 = num, w0
        bound = (1.0 / fin) if first else math.sqrt(6.0 / fin) / w0
        self.kernel = nn.Parameter(
            torch.empty(fin, fout).uniform_(-bound, bound, generator=gen))
        self.bias = nn.Parameter(
            torch.empty(fout).uniform_(-bound, bound, generator=gen))

    def forward(self, x, gamma=None, beta=None):
        out = self.num.mm(x, self.kernel) + self.bias
        if gamma is not None:
            out = out * gamma[:, None, :] + beta[:, None, :]
        return torch.sin(self.w0 * out)


class SirenNet(nn.Module):
    def __init__(self, num, fin, hidden, n_layers, gen):
        super().__init__()
        self.layers = nn.ModuleList(
            [Siren(num, fin if i == 0 else hidden, hidden,
                   W0_FIRST if i == 0 else W0, i == 0, gen)
             for i in range(n_layers)]
            + [Siren(num, hidden, hidden, W0, False, gen)])

    def forward(self, x, gammas, betas):
        for i, layer in enumerate(self.layers[:-1]):
            x = layer(x, gammas[:, i], betas[:, i])
        return self.layers[-1](x)


class Mapping(nn.Module):
    def __init__(self, num, dim, dim_out, heads, gen):
        super().__init__()
        width = dim * heads
        self.layers = nn.ModuleList(
            [Dense(num, dim if i == 0 else width, width, gen)
             for i in range(3)])
        self.to_gamma = Dense(num, width, dim_out * heads, gen)
        self.to_beta = Dense(num, width, dim_out * heads, gen)
        self.heads, self.dim_out = heads, dim_out

    def forward(self, z):
        x = z / torch.clamp(z.norm(dim=-1, keepdim=True), min=1e-12)
        for layer in self.layers:
            x = F.leaky_relu(layer(x), 0.2)
        shape = (z.shape[0], self.heads, self.dim_out)
        return self.to_gamma(x).reshape(shape), self.to_beta(x).reshape(shape)


class Field(nn.Module):
    def __init__(self, num, zdim, n_layers, hidden, gen):
        super().__init__()
        self.mapping = Mapping(num, zdim, hidden, n_layers, gen)
        self.rgb_mapping = Mapping(num, zdim, hidden, 1, gen)
        self.siren = SirenNet(num, 3, hidden, n_layers, gen)
        self.to_alpha = Dense(num, hidden, 1, gen)
        self.to_rgb_siren = Siren(num, hidden + 3, hidden, W0, False, gen)
        self.to_rgb = Dense(num, hidden, 3, gen)

    def forward(self, points, directions, z):
        gammas, betas = self.mapping(z)
        rgb_g, rgb_b = self.rgb_mapping(z)
        dirs = directions / torch.clamp(directions.norm(dim=-1, keepdim=True),
                                        min=1e-12)
        b, n, p, _ = points.shape
        x = self.siren(points.reshape(b, n * p, 3), gammas, betas)
        alpha = self.to_alpha(x)
        dirs = dirs[:, :, None, :].expand(b, n, p, 3).reshape(b, n * p, 3)
        x = self.to_rgb_siren(torch.cat([x, dirs], -1), rgb_g[:, 0],
                              rgb_b[:, 0])
        rgb = self.to_rgb(x)
        return (torch.sigmoid(alpha).reshape(b, n, p, 1),
                torch.sigmoid(rgb).reshape(b, n, p, 3))


class Renderer(nn.Module):
    """Holds the field under the program's module path."""

    def __init__(self, field):
        super().__init__()
        self.rad_field = field


class Generator(nn.Module):
    def __init__(self, num, v, gen):
        super().__init__()
        self.v = v
        self.nerf_renderer = Renderer(Field(
            num, int(v["model.noise_dim"]), int(v["nerf.siren_num_layers"]),
            int(v["nerf.siren_dim_hidden"]), gen))

    def forward(self, z, res, view_gen, depth_gen, fine_gen):
        v, b, dev = self.v, z.shape[0], z.device
        xy = pixel_grid(b, res, dev).reshape(b, -1, 2)
        az = torch.randint(int(v["generator.view_args.azimuth_low"]),
                           int(v["generator.view_args.azimuth_high"]), (b,),
                           generator=view_gen, device=dev).float()
        az = torch.rad2deg(torch.deg2rad(az))
        R, T = look_at(float(v["generator.view_args.camera_dist"]), az)
        origins, dirs = rays(R, T, xy)
        dirs = dirs / torch.clamp(dirs.norm(dim=-1, keepdim=True), min=1e-12)
        n_rays, n_c = xy.shape[1], int(v["nerf.n_pts_per_ray"])
        n_f = int(v["nerf.n_pts_per_ray_fine"])
        depths = torch.linspace(float(v["nerf.min_depth"]),
                                float(v["nerf.max_depth"]), n_c, device=dev)
        depths = depths.expand(b, n_rays, n_c)
        u = torch.rand((b, n_rays, n_c), generator=depth_gen, device=dev)
        mids = 0.5 * (depths[..., 1:] + depths[..., :-1])
        upper = torch.cat([mids, depths[..., -1:]], -1)
        lower = torch.cat([depths[..., :1], mids], -1)
        depths = lower + (upper - lower) * u
        chunk = int(v["nerf.chunk_size"])
        field = self.nerf_renderer.rad_field
        parts = []
        for lo in range(0, n_rays, chunk if 0 < chunk < n_rays else n_rays):
            hi = min(lo + chunk, n_rays) if 0 < chunk < n_rays else n_rays
            fu = torch.rand((b, hi - lo, n_f), generator=fine_gen, device=dev)
            o, d, dep = origins[:, lo:hi], dirs[:, lo:hi], depths[:, lo:hi]
            with torch.no_grad():
                dens, cols = field(points(o, d, dep), d, z)
                w = composite(dens[..., 0], cols)[1]
                m = 0.5 * (dep[..., 1:] + dep[..., :-1])
                fine = sample_pdf(m, w[..., 1:-1], fu)
                dep_f = torch.sort(torch.cat([dep, fine], -1), dim=-1).values
            dens, cols = field(points(o, d, dep_f), d, z)
            parts.append(composite(dens[..., 0], cols)[0])
        return torch.cat(parts, 1).reshape(b, res, res, 4)


def pixel_grid(b, res, dev):
    """(B, S, S, 2) NDC pixel centres, +x and +y pointing left and up."""
    half = 1.0 / res
    ys = torch.linspace(1.0 - half, -1.0 + half, res, device=dev)
    xs = torch.linspace(1.0 - half, -1.0 + half, res, device=dev)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([xx, yy], -1)[None].expand(b, res, res, 2)


def _unit(v, eps):
    return v / torch.clamp(v.norm(dim=-1, keepdim=True), min=eps)


def look_at(dist, az_deg):
    """Cameras at elevation 0, azimuth ``az_deg`` (B,), looking at the
    origin with +Y up: R's columns the camera axes, T = −eye·R."""
    el = torch.zeros_like(az_deg)
    az, el = torch.deg2rad(az_deg), torch.deg2rad(el)
    d = torch.full_like(az, dist)
    eye = torch.stack([d * torch.sin(az) * torch.cos(el), d * torch.sin(el),
                       d * torch.cos(az) * torch.cos(el)], -1)
    up = torch.tensor([0.0, 1.0, 0.0], device=eye.device).expand_as(eye)
    z_axis = _unit(-eye, 1e-8)
    x_axis = _unit(torch.linalg.cross(up, z_axis), 1e-8)
    y_axis = _unit(torch.linalg.cross(z_axis, x_axis), 1e-8)
    R = torch.stack([x_axis, y_axis, z_axis], -1)
    T = -torch.einsum("bi,bij->bj", eye, R)
    return R, T


def rays(R, T, xy):
    """Orthographic rays through NDC points: origins on the near plane
    and directions of length zfar − znear, in world coordinates."""
    b, n, _ = xy.shape
    view = torch.cat([xy, torch.full((b, n, 1), Z_NEAR, device=xy.device)], -1)
    rt = R.transpose(1, 2)
    origins = torch.einsum("bnj,bjk->bnk", view - T[:, None], rt)
    d = torch.tensor([0.0, 0.0, Z_FAR - Z_NEAR], device=xy.device)
    return origins, torch.einsum("bnj,bjk->bnk", d.expand(b, n, 3), rt)


def points(origins, dirs, depths):
    return origins[:, :, None] + depths[..., None] * dirs[:, :, None]


def composite(d, cols):
    """(RGB + opacity (..., 4), weights (..., P)) of densities (..., P)."""
    trans = torch.cumprod((1.0 + 1e-10) - d, -1)
    trans = torch.cat([torch.ones_like(d[..., :1]), trans[..., :-1]], -1)
    w = d * trans
    rgb = (w[..., None] * cols).sum(-2)
    opacity = 1.0 - torch.prod(1.0 - d, -1, keepdim=True)
    return torch.cat([rgb, opacity], -1), w


def sample_pdf(bins, weights, u, eps=1e-5):
    """Inverse-CDF samples at uniforms ``u`` of the piecewise-constant pdf
    ``weights`` over the edges ``bins``."""
    weights = weights + eps
    cdf = torch.cumsum(weights / weights.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    nb = cdf.shape[-1]
    below = (torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
             - 1).clamp(0, nb - 1)
    above = (below + 1).clamp(max=nb - 1)
    c0, c1 = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    b0, b1 = torch.gather(bins, -1, below), torch.gather(bins, -1, above)
    denom = torch.where(c1 - c0 < eps, torch.ones_like(c0), c1 - c0)
    return b0 + (u - c0) / denom * (b1 - b0)


def add_coords(x):
    n, _, h, w = x.shape
    ys = torch.linspace(-1.0, 1.0, h, device=x.device)
    xs = torch.linspace(-1.0, 1.0, w, device=x.device)
    c = torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)])
    return torch.cat([x, c[None].expand(n, 2, h, w)], 1)


class CoordConv(nn.Module):
    def __init__(self, num, fin, fout, k, gen, stride=1, padding=0):
        super().__init__()
        self.num, self.stride, self.padding = num, stride, padding
        self.weight = nn.Parameter(
            torch.empty(fout, fin + 2, k, k).normal_(0.0, 0.02, generator=gen))
        self.bias = nn.Parameter(torch.zeros(fout))

    def forward(self, x):
        return self.num.conv2d(add_coords(x), self.weight, self.bias,
                               self.stride, self.padding)


class DBlock(nn.Module):
    def __init__(self, num, fin, fout, gen):
        super().__init__()
        self.res = CoordConv(num, fin, fout, 1, gen, stride=2)
        self.conv1 = CoordConv(num, fin, fout, 3, gen, padding=1)
        self.conv2 = CoordConv(num, fout, fout, 3, gen, padding=1)

    def forward(self, x):
        h = F.leaky_relu(self.conv1(x), 0.2)
        h = F.leaky_relu(self.conv2(h), 0.2)
        return F.avg_pool2d(h, 2) + self.res(x)


class Discriminator(nn.Module):
    def __init__(self, num, img_size, init_chan, init_res, gen):
        super().__init__()
        n = int(math.log2(img_size)) - 1
        chans = [int(init_chan)] + [min(MAX_CHAN, c) for c in
                                    reversed([2 ** (11 - t)
                                              for t in range(n)])]
        self.resolutions = [2 ** (int(math.log2(img_size)) - t)
                            for t in range(n)]
        for i, r in enumerate(self.resolutions):
            if r >= init_res:
                setattr(self, f"from_rgb_{r}",
                        CoordConv(num, 3, chans[i], 1, gen))
            setattr(self, f"block_{r}", DBlock(num, chans[i], chans[i + 1],
                                               gen))
        self.final_conv = CoordConv(num, chans[-1], 1, 2, gen)

    def forward(self, img, alpha, res):
        x = img
        for r in self.resolutions:
            frgb = getattr(self, f"from_rgb_{r}", None)
            if res < r:
                continue
            if res == r:
                x = F.leaky_relu(frgb(x), 0.2)
            if r == res // 2 and frgb is not None:
                x = (x * (1.0 - alpha)
                     + F.leaky_relu(frgb(img[:, :, ::2, ::2]), 0.2) * alpha)
            x = getattr(self, f"block_{r}")(x)
        return self.final_conv(x).reshape(img.shape[0], -1)[:, 0]


def bilinear(images, xys):
    """Border-clamped bilinear samples of NHWC ``images`` at NDC ``xys``
    (B, ..., 2), x along W, y along H, [−1, 1] onto the pixel centres at
    the ends."""
    b, h, w, c = images.shape
    lead = xys.shape[1:-1]
    pts = xys.reshape(b, -1, 2)
    fx = (pts[..., 0] + 1.0) * 0.5 * (w - 1)
    fy = (pts[..., 1] + 1.0) * 0.5 * (h - 1)
    x0, y0 = torch.floor(fx), torch.floor(fy)
    x0i, x1i = x0.long().clamp(0, w - 1), (x0.long() + 1).clamp(0, w - 1)
    y0i, y1i = y0.long().clamp(0, h - 1), (y0.long() + 1).clamp(0, h - 1)
    flat = images.reshape(b, h * w, c)

    def at(yi, xi):
        return torch.gather(flat, 1, (yi * w + xi)[..., None].expand(-1, -1,
                                                                      c))

    ax, ay = (fx - x0)[..., None], (fy - y0)[..., None]
    out = (at(y0i, x0i) * (1 - ax) * (1 - ay) + at(y0i, x1i) * ax * (1 - ay)
           + at(y1i, x0i) * (1 - ax) * ay + at(y1i, x1i) * ax * ay)
    return out.reshape((b,) + lead + (c,))


class Reference(plain.GANReference):
    def __init__(self, values: dict, device, quant: bool = False):
        super().__init__(values, device, quant)
        self.reg = float(values["loss_weight.reg"])
        self.noise_dim = int(values["model.noise_dim"])
        self.add_layer_iters = int(values.get(
            "discriminator.add_layer_iters", 10000))
        self.d_lr = float(values["disc_optimiser.lr"])
        self.g_lr = float(values["gen_optimiser.lr"])
        self.betas = (float(values["optimisation.beta1"]),
                      float(values["optimisation.beta2"]))

    def init_from_seed(self, seed: int):
        v, num = self.values, self.num
        gen = torch.Generator().manual_seed(seed)
        self.G = Generator(num, v, gen).to(self.device)
        self.D = Discriminator(
            num, int(v["train.img_size"]), int(v["train.features_disc"]),
            int(v["resolution_annealing.resolutions"][0]), gen
        ).to(self.device)
        self.opt_d = plain.Adam(list(self.D.parameters()), self.betas)
        self.opt_g = plain.Adam(list(self.G.parameters()), self.betas)
        dev = self.device
        self.gens = {k: torch.Generator(dev).manual_seed(seed + i)
                     for i, k in ((1, "z"), (2, "view"), (3, "depth"),
                                  (4, "fine"))}
        self.extra = {"alpha": torch.zeros((), device=dev)}
        self.d_steps = self.g_steps = 0
        self.resolution = plain.schedule_at(v, 0)[2]

    def _decay(self, count, base, target):
        frac = min(max(count / 10000, 0.0), 1.0)
        return base * ((1.0 - frac) + target / base * frac)

    def lr_d(self, count):
        return self._decay(count, self.d_lr, self.d_lr / 4)

    def lr_g(self, count):
        return self._decay(count, self.g_lr, self.g_lr / 5)

    def update_extra(self):
        self.extra["alpha"] = torch.clamp(
            self.extra["alpha"] - 1.0 / self.add_layer_iters, min=0.0)

    def sample_z(self, n):
        return torch.randn((n, self.noise_dim), generator=self.gens["z"],
                           device=self.device)

    def _fake(self, z):
        g = self.gens
        img = self.G(z, self.resolution, g["view"], g["depth"], g["fine"])
        return img[..., :3].permute(0, 3, 1, 2)

    def _d(self, x):
        return self.D(x, self.extra["alpha"], self.resolution)

    def disc_loss(self, batch, z):
        images = batch["image"]
        rays_xy = pixel_grid(images.shape[0], self.resolution, images.device)
        real = bilinear(images.permute(0, 2, 3, 1).float(),
                        -rays_xy).permute(0, 3, 1, 2)
        with torch.no_grad():
            fake = self._fake(z)
        div = torch.mean(F.relu(1.0 + self._d(real))
                         + F.relu(1.0 - self._d(fake)))
        x = real.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(self._d(x).sum(), x, create_graph=True)
        r1 = self.reg * grad.square().reshape(x.shape[0], -1).sum(1).mean()
        loss = r1 + div
        return loss, {"d_loss": loss, "r1": r1}

    def gen_loss(self, batch, z):
        loss = torch.mean(self._d(self._fake(z)))
        return loss, {"g_loss": loss}
