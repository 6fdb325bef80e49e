"""UniRestore composite model (mirrors ``unirestore_tpu/models/unirestore.py``).

A frozen SD VAE + UNet with four adapter families (CFRM, Controller,
SC-Tuner, TFA). Parameters are two trees, ``frozen`` and ``trainable``, shaped
like the JAX pytrees. The DDIM loop is a Python loop over the static timestep
table; the ``none`` / ``encoder`` / ``deep`` cache modes keep the JAX
function's exact step order: warmup steps first, then groups of ``stride``
(one full key step and its cached followers), then the remainder as full
steps.

Randomness is injectable: ``restore`` / ``restore_padded`` / ``encode`` /
``diffuse`` take the posterior and diffusion noise as tensors, and draw from a
passed ``torch.Generator`` only where a tensor is omitted; ``restore`` and
``restore_padded`` draw both up front (``restore_noise``) and hand them to
their device-only cores (``restore_core``, ``restore_padded_core``), which
copy nothing from or to the host and so can be captured in a CUDA graph
(``graphs.py``). ``restore`` and ``restore_padded`` run under
``torch.inference_mode()`` on the card unless ``device`` says otherwise;
``encode``, ``diffuse`` and ``predict_z0`` (the training path,
``train/steps.py``) run with autograd as the caller has it.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from ..device import resolve_device
from ..diffusion import schedules as D
from ..nn import attention as ATT
from ..nn.init import make_init
from ..ops import resize as RS
from ..parallel import spatial as SP
from . import controller as CTRL
from . import unet as UN
from . import vae as VAE

# fixed train-time noising timestep buffer
TRAIN_TIMESTEPS = (249, 499, 749, 999, 999, 999)


@dataclasses.dataclass(frozen=True)
class UniRestoreConfig:
    vae: VAE.VAEConfig = dataclasses.field(default_factory=VAE.VAEConfig)
    unet: UN.UNetConfig = dataclasses.field(default_factory=UN.UNetConfig)
    controller: CTRL.ControllerConfig = dataclasses.field(
        default_factory=CTRL.ControllerConfig)
    use_cfrm: bool = True
    control_type: str = "scedit"  # "scedit" | "spade" | "none" (no Controller)
    tasks: tuple = ("ir",)
    prompt_len: int = 1
    use_tfa: bool = False
    num_inference_steps: int = 1
    # alias for cache_mode="encoder" (JAX ``encoder_propagation``); applies
    # when ddim_denoise gets no cache_mode and cfg.cache_mode is "none"
    encoder_propagation: bool = False
    # "none" = exact; "encoder" = reuse Controller + UNet encoder features at
    # follower steps; "deep" = reuse the deep UNet feature and recompute
    # only the full-resolution level at follower steps
    cache_mode: str = "none"
    cache_stride: int = 2
    cache_warmup: int = 0
    # preprocessing: upscale the short side to >= min_size, pad to a multiple
    min_size: int = 512
    pad_multiple: int = 64
    text_seq_len: int = 77
    # restore with the out-projection fused into the channel-flat attention
    # kernel (``nn/attention.py:fused_out_projection``); off by default, as the
    # JAX package's UNIRESTORE_FUSED_OUT_ATTN. Training never sets it.
    fused_out_attention: bool = False

    @property
    def use_cnet(self):
        return self.control_type in ("scedit", "spade")


def tiny_config(use_tfa: bool = True, control_type: str = "scedit",
                tasks=("ir", "cls", "seg")):
    return UniRestoreConfig(
        vae=VAE.tiny_vae_config(),
        unet=UN.tiny_unet_config(control_type),
        controller=CTRL.tiny_controller_config(),
        tasks=tasks, use_tfa=use_tfa, control_type=control_type,
        min_size=64, pad_multiple=64,
    )


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init(cfg: UniRestoreConfig, generator=None, *, device=None, dtype=torch.float32,
         seed: int = 0):
    """Returns (frozen, trainable) parameter trees drawn on ``device``.

    ``device="meta"`` gives the trees' shapes without memory (used by
    ``bridge`` to check converted params). Zero-init leaves stay zero.
    """
    ini = make_init(generator, resolve_device(device), dtype, seed)
    frozen = {
        "vae": VAE.vae_init(ini, cfg.vae),
        # null-prompt CLIP embedding; replaced by weights/sd_null_emb.npy when used
        "null_emb": ini.zeros((1, cfg.text_seq_len, cfg.unet.cross_attention_dim)),
    }
    trainable = {}
    if cfg.use_cnet:
        frozen["unet"] = UN.unet_init(ini, cfg.unet)
        trainable["controller"] = CTRL.controller_init(ini, cfg.controller)
        trainable["control"] = UN.control_adapters_init(ini, cfg.unet)
    if cfg.use_cfrm:
        trainable["cfrm"] = VAE.cfrm_adapter_init(ini, cfg.vae)
    if cfg.use_tfa:
        trainable["tfa"] = VAE.tfa_adapter_init(ini, cfg.vae, cfg.tasks, cfg.prompt_len)
    return frozen, trainable


def schedule(cfg: UniRestoreConfig, device="cpu") -> D.DiffusionSchedule:
    return D.make_schedule(device=device)


# ---------------------------------------------------------------------------
# core pieces
# ---------------------------------------------------------------------------


def encode(frozen, trainable, cfg, images, noise=None, generator=None, enable_fr=True,
           sample=True):
    """VAE encode with optional CFRM; images in [0,1] NHWC. Returns (latents, skips)."""
    fr = trainable.get("cfrm") if (enable_fr and cfg.use_cfrm) else None
    return VAE.encode(frozen["vae"], images, cfg.vae, noise=noise, generator=generator,
                      fr_params=fr, enable_fr=fr is not None, sample=sample)


def decode(frozen, trainable, cfg, latents, skips=None, task=None):
    """VAE decode with optional TFA task routing."""
    tfa = trainable.get("tfa") if cfg.use_tfa else None
    return VAE.decode(frozen["vae"], latents, cfg.vae, skips=skips, tfa_params=tfa,
                      task=task if tfa is not None else None, prompt_len=cfg.prompt_len)


def diffuse(sched, latents, noise=None, generator=None, timesteps=None):
    """DDPM-noise latents; returns (noised, noise, timesteps).

    Without ``timesteps``, each sample draws one from ``TRAIN_TIMESTEPS``;
    without ``noise``, a standard normal draw. Both draws use ``generator``.
    """
    if (timesteps is None or noise is None) and generator is None:
        raise ValueError("diffuse: pass the timesteps and noise, or a generator")
    if timesteps is None:
        buf = torch.tensor(TRAIN_TIMESTEPS, dtype=torch.int32, device=latents.device)
        idx = torch.randint(0, len(buf), (latents.shape[0],), generator=generator,
                            device=latents.device)
        timesteps = buf[idx]
    if noise is None:
        noise = torch.randn(latents.shape, generator=generator, device=latents.device,
                            dtype=latents.dtype)
    noise = noise.to(latents.dtype)
    return D.add_noise(sched, latents, noise, timesteps), noise, timesteps


def _null_context(frozen, bsz, dtype):
    null = frozen["null_emb"]
    return null.expand((bsz,) + tuple(null.shape[1:])).to(dtype)


def predict_eps(frozen, trainable, cfg, zt, conditions, timesteps):
    """Controller -> controlled UNet -> predicted noise."""
    control = CTRL.controller_apply(trainable["controller"], cfg.controller,
                                    conditions, timesteps)
    return UN.unet_apply(frozen["unet"], cfg.unet, zt, timesteps,
                         _null_context(frozen, zt.shape[0], zt.dtype), control=control,
                         control_params=trainable.get("control"))


def predict_z0(frozen, trainable, cfg, sched, zt, conditions, timesteps):
    """One-shot x0 prediction under Controller guidance."""
    eps = predict_eps(frozen, trainable, cfg, zt, conditions, timesteps)
    return D.predict_x0_from_eps(sched, zt, eps, timesteps)


def ddim_denoise(frozen, trainable, cfg, sched, zt, z0_lq, num_inference_steps=None,
                 encoder_propagation=False, cache_mode=None, cache_stride=None,
                 cache_warmup=None):
    """DDIM loop with per-step Controller control.

    Cache modes as the JAX function: ``encoder`` runs the Controller and UNet
    encoder only at key steps and the decoder alone at followers; ``deep``
    keeps the feature entering the shallowest up block and recomputes only
    the full-resolution level at followers. Steps: ``warmup`` full steps,
    then groups of ``stride`` (key + followers), then the remainder as full
    steps. ``encoder_propagation`` (or ``cfg.encoder_propagation`` when no
    ``cache_mode`` is passed and ``cfg.cache_mode`` is "none") is an alias for
    ``cache_mode="encoder"`` (JAX ``unirestore.py:211-215``).
    """
    n = num_inference_steps or cfg.num_inference_steps
    mode = cache_mode if cache_mode is not None else cfg.cache_mode
    if encoder_propagation or (cache_mode is None and cfg.encoder_propagation
                               and mode == "none"):
        mode = "encoder"
    if mode not in ("none", "encoder", "deep"):
        raise ValueError(f"cache_mode must be 'none', 'encoder' or 'deep', got {mode!r}")
    stride = cache_stride if cache_stride is not None else cfg.cache_stride
    warmup = cache_warmup if cache_warmup is not None else cfg.cache_warmup
    if warmup < 0:
        raise ValueError(f"cache_warmup must be >= 0, got {warmup}")
    ts = [int(t) for t in D.ddim_timesteps(n)]
    bsz = zt.shape[0]

    def tvec(t):
        return torch.full((bsz,), t, dtype=torch.int32, device=zt.device)

    def full_step(z, t):
        eps = predict_eps(frozen, trainable, cfg, z, z0_lq, tvec(t))
        return D.ddim_step(sched, z, eps, t, n)

    z = zt
    if mode == "none" or n < 2 or stride < 2 or warmup >= n:
        for t in ts:
            z = full_step(z, t)
        return z

    unet_p = frozen["unet"]
    null = _null_context(frozen, bsz, zt.dtype)
    ctrl_params = trainable.get("control")

    for t in ts[:warmup]:  # exact warmup steps before caching kicks in
        z = full_step(z, t)
    ts = ts[warmup:]
    n_groups = len(ts) // stride
    for g in range(n_groups):
        group = ts[g * stride:(g + 1) * stride]
        # key step: Controller + full UNet, caching features
        tb0 = tvec(group[0])
        control = CTRL.controller_apply(trainable["controller"], cfg.controller, z0_lq, tb0)
        emb0 = UN.unet_time_embedding(unet_p, cfg.unet, tb0, z.dtype)
        h, skips = UN.unet_encode(unet_p, cfg.unet, z, emb0, null, control, ctrl_params)
        eps0, deep = UN.unet_decode(unet_p, cfg.unet, h, skips, emb0, null, control,
                                    ctrl_params, return_deep=True)
        z = D.ddim_step(sched, z, eps0, group[0], n)
        # follower steps: cached features + fresh timestep embedding
        for t in group[1:]:
            embj = UN.unet_time_embedding(unet_p, cfg.unet, tvec(t), z.dtype)
            if mode == "deep":
                skips0 = UN.unet_down_shallow(unet_p, cfg.unet, z, embj, null, control,
                                              ctrl_params)
                epsj = UN.unet_up_shallow(unet_p, cfg.unet, deep, skips0, embj, null,
                                          control, ctrl_params)
            else:
                epsj = UN.unet_decode(unet_p, cfg.unet, h, skips, embj, null, control,
                                      ctrl_params)
            z = D.ddim_step(sched, z, epsj, t, n)
    for t in ts[n_groups * stride:]:  # trailing remainder runs in full
        z = full_step(z, t)
    return z


def latent_shape(cfg, images_shape) -> tuple:
    """The posterior mean's (and the latents') shape for padded NHWC images of
    ``images_shape``: the VAE encoder halves H and W once per down block."""
    b, h, w = images_shape[:3]
    f = 2 ** (len(cfg.vae.block_out_channels) - 1)
    return (b, h // f, w // f, cfg.vae.latent_channels)


def restore_noise(cfg, images_shape, dtype, generator=None, device=None, posterior_noise=None,
                  diffusion_noise=None):
    """A restore's (posterior, diffusion) noise on ``device`` for padded images
    of ``images_shape`` and ``dtype``.

    Each is the tensor given, else a standard normal draw from ``generator``,
    posterior first, with the shape and dtype that ``VAE.encode`` and
    ``diffuse`` draw: so eager and graph restores take the same numbers from
    the same seeded generator. The diffusion noise is None without the
    Controller (no DDIM loop).
    """
    lat = latent_shape(cfg, images_shape)
    if not dtype.is_floating_point:  # the encoder's ``x * 2.0 - 1.0`` promotes
        dtype = torch.get_default_dtype()
    out = []
    for noise, wanted in ((posterior_noise, True), (diffusion_noise, cfg.use_cnet)):
        if not wanted:
            out.append(None)
        elif noise is not None:
            out.append(torch.as_tensor(noise, device=device))
        elif generator is None:
            raise ValueError("restore: pass the posterior and diffusion noise, or a generator")
        else:
            out.append(torch.randn(lat, generator=generator, device=device, dtype=dtype))
    return tuple(out)


def restore_padded_core(frozen, trainable, cfg, sched, images, task, posterior_noise,
                        diffusion_noise, num_inference_steps=None):
    """The device-only work of ``restore_padded``: images, noise and schedule
    already on the device; no host copy, host read or generator.

    encode (CFRM on) -> noise to t=999 -> DDIM loop -> decode (TFA task),
    with the out-projection-fused attention route if ``cfg.fused_out_attention``.
    """
    with torch.inference_mode(), ATT.fused_out_projection(cfg.fused_out_attention):
        z0, skips = encode(frozen, trainable, cfg, images, noise=posterior_noise, enable_fr=True)
        zt = z0
        if cfg.use_cnet:
            t999 = torch.full((images.shape[0],), 999, dtype=torch.int32, device=images.device)
            zt, _, _ = diffuse(sched, z0, noise=diffusion_noise, timesteps=t999)
            zt = ddim_denoise(frozen, trainable, cfg, sched, zt, z0, num_inference_steps)
        return decode(frozen, trainable, cfg, zt, skips, task)


def spatial_levels(cfg, height: int) -> list:
    """(name, rows) of every map a restore of images ``height`` rows high runs
    at, down to the UNet's and Controller's coarsest (latent / 8 at sd-turbo's
    widths)."""
    n_vae = len(cfg.vae.block_out_channels) - 1
    out = [("image", height)] + [(f"VAE encoder level {k} (image / {2 ** k})", height // 2 ** k)
                                 for k in range(1, n_vae + 1)]
    if cfg.use_cnet:
        latent = height // 2 ** n_vae
        n_unet = max(len(cfg.unet.block_out_channels), len(cfg.controller.channel_mult)) - 1
        out += [(f"UNet level {k} (latent / {2 ** k})", latent // 2 ** k)
                for k in range(1, n_unet + 1)]
    return out


def check_spatial_heights(cfg, height: int, spatial: int) -> None:
    """Raise ``ValueError`` naming the first map whose height the ``spatial``
    ranks do not divide: every level's slab must be whole (and even where it is
    downsampled). GSPMD pads uneven shards; the port refuses them."""
    levels = spatial_levels(cfg, height)
    for k, (name, rows) in enumerate(levels):
        if rows * 2 ** k != height or rows % spatial:
            raise ValueError(f"spatial sharding over {spatial} ranks: the {name} is {rows} rows "
                             f"high (images {height} rows), not a whole slab a rank")


def restore_padded(frozen, trainable, cfg, sched, images, task, generator=None,
                   num_inference_steps=None, *, posterior_noise=None,
                   diffusion_noise=None, device=None, sharding=None):
    """Restore images whose H/W are already multiples of pad_multiple.

    ``posterior_noise`` (shape of the /8 latent mean) and ``diffusion_noise``
    (shape of the latents) are used when given, else drawn from ``generator``
    (``restore_noise``); then ``restore_padded_core``.

    With ``sharding`` (``parallel.spatial_batch_sharding``), ``images`` is this
    rank's block of a global batch (rows over ``data``, a slab of the height
    over ``spatial``) and the result is this rank's block of the global
    result (``sharding.assemble`` puts it together). The noise is drawn, or
    given, at the global latent shape and cut to the rank's block, so that a
    sharded and a single-process restore take the same numbers from the same
    seed. A spatial axis of more than one rank runs the restore under the
    partition context of ``parallel/spatial.py`` (``sharding.last_context``
    then holds its collective counts), after ``check_spatial_heights``.
    """
    if sharding is None:
        SP.refuse("restore_padded without its sharding", "pass sharding= for a rank's slab")
    dev = resolve_device(device)
    with torch.inference_mode():
        images = torch.as_tensor(images, device=dev)
        shape = images.shape if sharding is None else sharding.global_shape(images.shape)
        ctx = None if sharding is None else sharding.context(shape[1])
        if ctx is not None:
            check_spatial_heights(cfg, shape[1], ctx.size)
        post, diff = restore_noise(cfg, shape, images.dtype, generator, dev,
                                   posterior_noise, diffusion_noise)
        if sharding is not None:
            post, diff = (None if n is None else sharding.local(n) for n in (post, diff))
        with SP.partition(ctx) if ctx is not None else contextlib.nullcontext():
            return restore_padded_core(frozen, trainable, cfg, sched.to(dev), images, task, post,
                                       diff, num_inference_steps)


def preprocess_shape(h: int, w: int, cfg: UniRestoreConfig):
    """Upscale the short side to >= min_size (Python's banker's ``round``),
    then pad to a multiple of pad_multiple. Returns (h, w, pad_h, pad_w)."""
    if h < cfg.min_size or w < cfg.min_size:
        s = cfg.min_size / min(h, w)
        h, w = round(h * s), round(w * s)
    m = cfg.pad_multiple
    return h, w, (m - h % m) % m, (m - w % m) % m


def padded_shape(images_shape, cfg: UniRestoreConfig) -> tuple:
    """The NHWC shape ``restore`` hands to ``restore_padded_core``."""
    b, h, w, c = images_shape
    h, w, pad_h, pad_w = preprocess_shape(h, w, cfg)
    return (b, h + pad_h, w + pad_w, c)


def restore_core(frozen, trainable, cfg, sched, images, task, posterior_noise, diffusion_noise,
                 num_inference_steps=None):
    """The device-only work of ``restore`` (resize and reflect-pad,
    ``restore_padded_core``, crop and resize back): every input already a
    tensor on the device, the noise given. This is what ``graphs.GraphedRestore``
    captures. It refuses height-sharded images (``parallel/spatial.py``): the
    bicubic resize and the reflect-pad read rows of the whole image."""
    SP.refuse("restore", "its resize and reflect-pad read the whole image; "
              "use restore_padded with a sharding")
    with torch.inference_mode():
        org_h, org_w = images.shape[1:3]
        h, w, pad_h, pad_w = preprocess_shape(org_h, org_w, cfg)
        x = images
        if (h, w) != (org_h, org_w):
            x = RS.resize_bicubic(x, (h, w))
        x = RS.reflect_pad_hw(x, pad_h, pad_w)
        preds = restore_padded_core(frozen, trainable, cfg, sched, x, task, posterior_noise,
                                    diffusion_noise, num_inference_steps)
        preds = preds[:, :h, :w]
        if (h, w) != (org_h, org_w):
            preds = RS.resize_bicubic(preds, (org_h, org_w))
        return preds


def restore(frozen, trainable, cfg, sched, images, task, generator=None,
            num_inference_steps=None, *, posterior_noise=None, diffusion_noise=None,
            device=None):
    """Full restore: the inputs to the device, the noise (``restore_noise``),
    then ``restore_core``."""
    dev = resolve_device(device)
    with torch.inference_mode():
        x = torch.as_tensor(images, device=dev)
        post, diff = restore_noise(cfg, padded_shape(x.shape, cfg), x.dtype, generator, dev,
                                   posterior_noise, diffusion_noise)
        return restore_core(frozen, trainable, cfg, sched.to(dev), x, task, post, diff,
                            num_inference_steps)
