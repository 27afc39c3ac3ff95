"""avec_tpu_torch.decode (mirrors avec_tpu/decode): the decoder registry by
the names the JAX `compile` takes (avec_tpu/decode/__init__.py:14-21)."""

from avec_tpu_torch.decode.beam import CTCBeamSearchDecoder
from avec_tpu_torch.decode.device_beam import CTCDeviceBeamSearchDecoder
from avec_tpu_torch.decode.greedy import (ArgMaxDecoder,
                                          CTCGreedySearchDecoder,
                                          IdentityDecoder, ThresholdDecoder)

decoder_dict = {
    "Identity": IdentityDecoder,
    "Threshold": ThresholdDecoder,
    "ArgMax": ArgMaxDecoder,
    "CTCGreedySearchDecoder": CTCGreedySearchDecoder,
    "CTCBeamSearch": CTCBeamSearchDecoder,
    "CTCDeviceBeamSearch": CTCDeviceBeamSearchDecoder,
}
