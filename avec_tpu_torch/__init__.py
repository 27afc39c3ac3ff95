"""avec_tpu_torch: the PyTorch / CUDA (H100) port of avec_tpu.

It imports torch and numpy only, never JAX or the `avec_tpu` package. Its
modules mirror `avec_tpu/` (ops/, models/, decode/, train/, serve.py,
convert.py).
Every Pallas TPU kernel on a ported path is a hand-written CUDA kernel under
`csrc/`, built with nvcc at first use; each has a plain PyTorch twin that the
CPU runs and that the kernel is held against on the card.

The package exports the counterpart of every public name of
`avec_tpu/__init__.py`, under the same name, with two exceptions: `Model`
is `train.model.Trainer` (the port's engine is a trainer around an
`nn.Module`), and `mesh` is `parallel.dist` (torch.distributed in place of
a device mesh). Importing it initialises no CUDA context.
"""

# --- ops / core --------------------------------------------------------
from avec_tpu_torch.ops import (activations, attention, audio, ctc,  # noqa: F401
                                inits, layers, masks)
from avec_tpu_torch.ops.audio import AudioPreprocessing, SpecAugment  # noqa: F401
from avec_tpu_torch.ops.ctc import ctc_loss  # noqa: F401
from avec_tpu_torch.ops.pos_embeddings import (  # noqa: F401
    PosEmbedding1d, SinPosEmbedding)

# --- training engine ----------------------------------------------------
from avec_tpu_torch.train import schedulers  # noqa: F401
from avec_tpu_torch.train.model import Trainer  # noqa: F401
from avec_tpu_torch.ops.rnnt import RNNTLoss, rnnt_loss  # noqa: F401
from avec_tpu_torch.train.losses import (  # noqa: F401
    CTCLoss, HingeLoss, HuberLoss, MeanAbsoluteError, MeanLoss,
    MeanSquaredError, SoftmaxCrossEntropy)
from avec_tpu_torch.train.metrics import (  # noqa: F401
    CategoricalAccuracy, CategoricalAccuracyTopK, Mean, WordErrorRate)
from avec_tpu_torch.train.optim import SGD, Adam, AdamW  # noqa: F401
from avec_tpu_torch.train.schedulers import (  # noqa: F401
    ConstantDecayScheduler, ConstantScheduler, CosineAnnealingScheduler,
    ExpDecayScheduler, LinearDecayScheduler, NoamDecayScheduler,
    WarmupConstantDecayScheduler)

# --- models -------------------------------------------------------------
from avec_tpu_torch.models.encoders import (  # noqa: F401
    AudioEfficientConformerEncoder, AudioVisualEfficientConformerEncoder,
    VisualEfficientConformerEncoder)
from avec_tpu_torch.models.resnet import ResNet  # noqa: F401
from avec_tpu_torch.models.transformer import GPTNet, Transformer  # noqa: F401
from avec_tpu_torch.models.zoo import (  # noqa: F401
    GPT, AudioEfficientConformerInterCTC,
    AudioVisualEfficientConformerInterCTC, Classifier,
    VisualEfficientConformerCE, VisualEfficientConformerInterCTC)

# --- decoding -----------------------------------------------------------
from avec_tpu_torch.decode.beam import CTCBeamSearchDecoder  # noqa: F401
from avec_tpu_torch.decode.device_beam import (  # noqa: F401
    CTCDeviceBeamSearchDecoder)
from avec_tpu_torch.decode.greedy import (  # noqa: F401
    ArgMaxDecoder, CTCGreedySearchDecoder, IdentityDecoder, ThresholdDecoder)

# --- data ---------------------------------------------------------------
from avec_tpu_torch import data  # noqa: F401
from avec_tpu_torch.data import datasets  # noqa: F401
from avec_tpu_torch.data.collate import Collate, CollateFn  # noqa: F401
from avec_tpu_torch.data.loader import DataLoader  # noqa: F401
from avec_tpu_torch.data.transforms import (  # noqa: F401
    BabbleNoise, CenterCrop, Compose, DenormalizeVideo, NormalizeVideo,
    RandomCrop, RandomHorizontalFlip, TimeMaskSecond, align_video_to_audio)

# --- utils --------------------------------------------------------------
from avec_tpu_torch.parallel import dist  # noqa: F401
from avec_tpu_torch.utils.tokenizer import (  # noqa: F401
    Tokenizer, load_tokenizer, train_tokenizer)
from avec_tpu_torch.utils.wer import wer  # noqa: F401

# the two names the port spells differently (see the module docstring)
RENAMED = {"Model": "Trainer", "mesh": "dist"}
