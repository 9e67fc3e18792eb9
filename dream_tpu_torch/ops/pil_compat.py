"""Single-image host preprocessing on uint8 arrays: the port of
``dream_tpu/ops/pil_compat.py``.

``dream_tpu`` preprocesses batches on the device (its ``ops/image_proc``,
here :mod:`dream_tpu_torch.ops.image_proc`); these host helpers cover the
reference's single-image utilities (reference dream/image_proc.py:26-90,
291-459) for visualization tools.  ``dream_tpu`` takes PIL images; the port
takes uint8 ``[H, W, 3]`` arrays (or torch tensors, moved to the host) and
returns new arrays, resized with Pillow's BILINEAR filter
(:func:`dream_tpu_torch.utils.resample.resize`, pixel for pixel).  Sizes
and resolutions are ``(width, height)``.
"""

from __future__ import annotations

from dream_tpu_torch.utils import resample
from dream_tpu_torch.utils.resolutions import KNOWN_IMAGE_PREPROC_TYPES, shrink_and_crop_resolution


def _size(image):
    return image.shape[1], image.shape[0]


def scale_image(image, factor=-1, new_width=-1, new_height=-1):
    """Aspect-preserving resize (reference dream/image_proc.py:416-459)."""
    image = resample.as_image(image)
    image_width, image_height = _size(image)
    if factor > 0:
        new_width = int(image_width * factor)
        new_height = int(image_height * factor)
    elif new_width > 0:
        new_height = int(image_height * (new_width / image_width))
    elif new_height > 0:
        new_width = int(image_width * (new_height / image_height))
    else:
        raise ValueError("scale_image: Must specify either 'factor', or 'new_width', or 'new_height'.")
    return resample.resize(image, (new_width, new_height))


def crop_image(image, u, v, cropped_width, cropped_height):
    """Parity: reference dream/image_proc.py:354-369."""
    return resample.crop(resample.as_image(image), (u, v, u + cropped_width, v + cropped_height))


def centered_crop_image(image, cropped_width, cropped_height):
    """Parity: reference dream/image_proc.py:372-413; returns the crop and
    its upper-left corner."""
    image = resample.as_image(image)
    image_width, image_height = _size(image)
    if not (0 < cropped_width <= image_width and 0 < cropped_height <= image_height):
        raise ValueError("centered_crop_image: the crop must fit inside the image")
    crop_u = (image_width - cropped_width) // 2
    crop_v = (image_height - cropped_height) // 2
    return crop_image(image, crop_u, crop_v, cropped_width, cropped_height), (crop_u, crop_v)


def shrink_and_crop_image(input_image, image_ref_resolution):
    """Parity: reference dream/image_proc.py:291-315."""
    input_image = resample.as_image(input_image)
    cropped_res, cropped_coords = shrink_and_crop_resolution(_size(input_image), image_ref_resolution)
    cropped, coords = centered_crop_image(input_image, cropped_res[0], cropped_res[1])
    assert coords == cropped_coords
    return resample.resize(cropped, tuple(image_ref_resolution))


def preprocess_image(input_image, image_ref_resolution, image_preprocessing):
    """Single-image host preprocessing (reference dream/image_proc.py:26-51)."""
    input_image = resample.as_image(input_image)
    if image_preprocessing not in KNOWN_IMAGE_PREPROC_TYPES:
        raise ValueError(f'Image preprocessing type "{image_preprocessing}" is not recognized.')
    if image_preprocessing == "none":
        return input_image.copy()
    if image_preprocessing == "resize":
        return resample.resize(input_image, tuple(image_ref_resolution))
    if image_preprocessing == "shrink":
        return scale_image(input_image, new_height=image_ref_resolution[1])
    return shrink_and_crop_image(input_image, image_ref_resolution)


def inverse_preprocess_image(preprocessed_image, image_input_resolution, image_preprocessing):
    """Parity: reference dream/image_proc.py:54-90 (shrink-and-crop is lossy:
    the un-cropped area is filled black)."""
    preprocessed_image = resample.as_image(preprocessed_image)
    if image_preprocessing not in KNOWN_IMAGE_PREPROC_TYPES:
        raise ValueError(f'Image preprocessing type "{image_preprocessing}" is not recognized.')
    image_input_resolution = tuple(image_input_resolution)
    if image_preprocessing == "none":
        return preprocessed_image.copy()
    if image_preprocessing in ("resize", "shrink"):
        return resample.resize(preprocessed_image, image_input_resolution)
    cropped_res, cropped_coords = shrink_and_crop_resolution(
        image_input_resolution, _size(preprocessed_image))
    canvas = resample.new(image_input_resolution)
    return resample.paste(canvas, resample.resize(preprocessed_image, cropped_res), cropped_coords)


def convert_image_to_netin_from_netout(image_netout, net_input_resolution):
    """Parity: reference dream/image_proc.py:263-274."""
    return resample.resize(resample.as_image(image_netout), tuple(net_input_resolution))


def convert_image_to_netout_from_netin(image_netin, net_output_resolution):
    """Parity: reference dream/image_proc.py:277-288."""
    return resample.resize(resample.as_image(image_netin), tuple(net_output_resolution))
