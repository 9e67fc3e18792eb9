"""torch model zoo of the port: the vgg hourglasses and ResnetSimple."""

from dream_tpu_torch.models.hourglass import DreamHourglass, DreamHourglassMultiStage
from dream_tpu_torch.models.resnet_simple import ResnetSimple
