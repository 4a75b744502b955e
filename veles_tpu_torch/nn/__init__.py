"""Neural-network layers of the port: the layer functions the fused
classifier trainer uses (activations, convolution, pooling, LRN,
learning-rate policies) and the unit library of the unit graph
(forward units, their gradient-descent twins, evaluators, decision,
dropout and the learning-rate scheduler), as ``veles_tpu/nn/`` exports
them. ``deconv``, ``rnn``, ``rbm`` and ``kohonen`` are listed in
ROADMAP.md queue 1 item 5."""

from veles_tpu_torch.nn.activation import ACTIVATIONS, DERIVATIVES  # noqa: F401
from veles_tpu_torch.nn.all2all import (All2All, All2AllRELU,  # noqa: F401
                                        All2AllSigmoid, All2AllSoftmax,
                                        All2AllTanh)
from veles_tpu_torch.nn.conv import (Conv, ConvRELU, ConvSigmoid,  # noqa: F401
                                     ConvTanh)
from veles_tpu_torch.nn.decision import DecisionGD, DecisionMSE  # noqa: F401
from veles_tpu_torch.nn.dropout import Dropout, GDDropout  # noqa: F401
from veles_tpu_torch.nn.evaluator import (EvaluatorBase,  # noqa: F401
                                          EvaluatorMSE, EvaluatorSoftmax)
from veles_tpu_torch.nn.gd import (GradientDescent, GDRELU,  # noqa: F401
                                   GDSigmoid, GDSoftmax, GDTanh, gd_for)
from veles_tpu_torch.nn.gd_conv import (GDConv, GDConvRELU,  # noqa: F401
                                        GDConvSigmoid, GDConvTanh)
from veles_tpu_torch.nn.gd_pooling import (GDAvgPooling,  # noqa: F401
                                           GDMaxPooling)
from veles_tpu_torch.nn.lrn import (GDLRNormalizer,  # noqa: F401
                                    LRNormalizerForward)
from veles_tpu_torch.nn.pooling import (AvgPooling, MaxPooling,  # noqa: F401
                                        Pooling)
from veles_tpu_torch.nn.lr_policy import (LRScheduler,  # noqa: F401
                                          make_policy, step_decay,
                                          warmup_cosine)
