"""The AO-Tone-Causal learning run with the port
(configs/Synthetic/AO-Tone-Causal.py): the AO-Tone run
(`avec_tpu_torch/configs/ao_tone.py`, the same data, sizes and schedule) on
the causal variant of the audio-only model, `causal=True` with a left
context of 64 stage-1 frames (1.28 s of audio, :42-47). Every output frame
depends on past audio only. The config decodes greedily (:38-40).

    setup = build(callback_path="callbacks/AO-Tone-Causal-torch")
    setup.trainer.fit(setup.train_loader, epochs=setup.epochs,
                      dataset_eval=setup.eval_loader,
                      callback_path=setup.callback_path,
                      recompute_metrics=setup.recompute_metrics)
"""

from avec_tpu_torch.configs import ao_tone
from avec_tpu_torch.decode.greedy import CTCGreedySearchDecoder

LEFT_CONTEXT = 64                                  # AO-Tone-Causal.py:47


def build(callback_path: str, **kwargs) -> ao_tone.Setup:
    """`ao_tone.build` with `causal=True, left_context=64` and the greedy
    decoder; the same keyword arguments (`device`, `route`, `precision`,
    `seed`, the sizes)."""
    return ao_tone.build(callback_path, causal=True,
                         left_context=LEFT_CONTEXT,
                         decoder=CTCGreedySearchDecoder, **kwargs)
