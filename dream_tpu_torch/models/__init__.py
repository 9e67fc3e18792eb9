"""torch model zoo of the port: the vgg hourglasses, ResnetSimple and its
BatchNorm-folded deploy graph, and DopeNetworkBelief."""

from dream_tpu_torch.models.dope import DopeNetworkBelief
from dream_tpu_torch.models.hourglass import DreamHourglass, DreamHourglassMultiStage
from dream_tpu_torch.models.resnet_deploy import ResnetSimpleDeploy, fold_batchnorm_resnet
from dream_tpu_torch.models.resnet_simple import ResnetSimple
