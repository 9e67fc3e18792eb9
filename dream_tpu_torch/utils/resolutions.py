"""Static resolution algebra for image preprocessing and network geometry.

A copy of ``dream_tpu/utils/resolutions.py``: the port imports nothing of the
JAX package, so it keeps its own copy of this pure-Python module.  All
functions operate on plain Python integers; output resolutions come from
exact stride arithmetic, so building a network never needs a forward pass.

Resolution conventions follow the reference: a "resolution" is a
``(width, height)`` tuple (reference dream/image_proc.py:93-132).
"""

from __future__ import annotations

KNOWN_IMAGE_PREPROC_TYPES = [
    "none",  # No preprocessing; output == input.
    "resize",  # Resize (aspect ratio NOT preserved) to the reference resolution.
    "shrink",  # Resize (aspect preserved) to the reference height.
    "shrink-and-crop",  # Center-crop to reference aspect, then resize.
]
# Semantics per reference dream/image_proc.py:18-23.


def shrink_resolution(image_input_resolution, image_ref_resolution):
    """Aspect-preserving resolution targeting the reference height.

    Parity: reference dream/image_proc.py:127-132 (int truncation of width).
    """
    factor = float(image_ref_resolution[1]) / float(image_input_resolution[1])
    new_width = int(image_input_resolution[0] * factor)
    return (new_width, image_ref_resolution[1])


def shrink_and_crop_resolution(image_input_resolution, image_ref_resolution):
    """Centered crop box achieving the reference aspect ratio.

    Returns ``(cropped_resolution, crop_upper_left_coords)`` in the *input*
    image frame.  Parity: reference dream/image_proc.py:318-351.
    """
    in_w, in_h = image_input_resolution
    ref_w, ref_h = image_ref_resolution

    scale_by_w = float(in_w) / float(ref_w)
    ref_h_by_w = int(scale_by_w * ref_h)

    scale_by_h = float(in_h) / float(ref_h)
    ref_w_by_h = int(scale_by_h * ref_w)

    if in_w >= ref_w_by_h:
        cropped_res = (ref_w_by_h, in_h)
    else:
        assert in_h >= ref_h_by_w, (
            "shrink-and-crop: input cannot satisfy reference aspect ratio"
        )
        cropped_res = (in_w, ref_h_by_w)

    cropped_coords = ((in_w - cropped_res[0]) // 2, (in_h - cropped_res[1]) // 2)
    return cropped_res, cropped_coords


def resolution_after_preprocessing(
    image_input_resolution, image_ref_resolution, image_preprocessing
):
    """Resolution of the preprocessed image (reference dream/image_proc.py:93-124)."""
    assert len(image_input_resolution) == 2
    assert len(image_ref_resolution) == 2
    assert image_preprocessing in KNOWN_IMAGE_PREPROC_TYPES, (
        f'Image preprocessing type "{image_preprocessing}" is not recognized.'
    )

    if image_preprocessing == "none":
        return tuple(image_input_resolution)
    if image_preprocessing == "resize":
        return tuple(image_ref_resolution)
    if image_preprocessing == "shrink":
        return shrink_resolution(image_input_resolution, image_ref_resolution)
    # shrink-and-crop
    return tuple(image_ref_resolution)


# -----------------------------------------------------------------------------
# Analytic network output resolutions.
#
# The reference discovers these by running a zeros tensor through the model on
# GPU (reference dream/network.py:397-418).  We compute them exactly from the
# layer stride arithmetic of each architecture (reference dream/models.py).
# -----------------------------------------------------------------------------


def _vgg_encoder_dim(d: int) -> int:
    """Four stride-2 max-pools, floor division (reference dream/models.py:589,761-772)."""
    for _ in range(4):
        d = d // 2
    return d


def vgg_output_resolution(
    net_input_resolution, deconv_decoder: bool = False, full_output: bool = False
):
    """Output resolution of DreamHourglass.

    - upsample decoder (default): two nearest x2 upsamples from the 1/16
      bottleneck -> 1/4 input resolution (reference dream/models.py:688-710).
    - deconv decoder: four stride-2 transposed convs (k3, p1, outp1), each
      exactly doubling -> full input resolution (reference dream/models.py:618-686).
    - full_output: two extra x2 upsamples -> full input resolution
      (reference dream/models.py:712-733).
    """
    w, h = net_input_resolution
    bw, bh = _vgg_encoder_dim(w), _vgg_encoder_dim(h)
    if deconv_decoder or full_output:
        return (bw * 16, bh * 16)
    return (bw * 4, bh * 4)


def _resnet_stride2_dim(d: int) -> int:
    """conv k7 s2 p3 / maxpool k3 s2 p1 / bottleneck s2 all give (d-1)//2 + 1."""
    return (d - 1) // 2 + 1


def resnet_output_resolution(net_input_resolution, full: bool = False):
    """Output resolution of ResnetSimple.

    ResNet-101 trunk downsamples 5x (conv1, maxpool, layer2, layer3, layer4);
    the decoder applies 4 (or 5 for ``full``) k4/s2/p1 transposed convs, each
    exactly doubling (reference dream/models.py:37-136,138-155).
    """
    w, h = net_input_resolution
    for _ in range(5):
        w, h = _resnet_stride2_dim(w), _resnet_stride2_dim(h)
    n_deconv = 5 if full else 4
    return (w * (2 ** n_deconv), h * (2 ** n_deconv))


def net_output_resolution_from_input_resolution(
    net_input_resolution, architecture_type: str, **arch_kwargs
):
    """Dispatch on architecture type (analytic equivalent of
    reference dream/network.py:397-418)."""
    if architecture_type == "vgg":
        return vgg_output_resolution(
            net_input_resolution,
            deconv_decoder=arch_kwargs.get("deconv_decoder", False),
            full_output=arch_kwargs.get("full_output", False),
        )
    if architecture_type == "resnet":
        return resnet_output_resolution(
            net_input_resolution, full=arch_kwargs.get("full", False)
        )
    raise ValueError(f"Unknown architecture type: {architecture_type}")
