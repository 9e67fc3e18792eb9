"""Tensor functions of the port: preprocessing, coordinates, decoding, PnP."""


def kernel_launches():
    """The launch counts of this process's kernel wrappers, by kernel."""
    from dream_tpu_torch.ops.conv_int8 import conv3x3_int8_kernel
    from dream_tpu_torch.ops.score_kernel import score_maps_kernel
    from dream_tpu_torch.ops.warp import warp_batch_kernel

    return {"score_kernel": score_maps_kernel.launches, "warp_kernel": warp_batch_kernel.launches,
            "conv_int8_kernel": conv3x3_int8_kernel.launches}
