"""torch model zoo of the port (vgg-Q hourglass so far)."""

from dream_tpu_torch.models.hourglass import DreamHourglass
