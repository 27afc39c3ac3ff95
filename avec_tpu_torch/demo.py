"""Transcribe one video with the AO, VO or AV model (port of demo.py).

    python -m avec_tpu_torch.demo --video clip.mp4 --mode av \
        [--checkpoint ckpt.ckpt] [--tokenizer tok.json] [--device cuda]

`load_av_inputs` reads a mouth-crop video and the .wav beside it: frames
resized to 96x96, grayscale, / 255, `NormalizeVideo`, `CenterCrop(88)`; the
audio resampled to 16 kHz; the video aligned to the audio. Reading video
needs OpenCV (`cv2`); without it the call raises ImportError.
"""

import argparse
import os

import numpy as np


def load_av_inputs(video_path, crop_size=(88, 88)):
    """(video (T, 88, 88, 1) float32, audio (Ta,) float32 or None, fps)."""
    from avec_tpu_torch.data.transforms import (CenterCrop, NormalizeVideo,
                                                align_video_to_audio)
    from avec_tpu_torch.utils import media

    frames, fps = media.read_video(video_path)
    cv2 = media._cv2()
    frames = np.stack([cv2.resize(f, (96, 96)) for f in frames])
    video = media.rgb_to_grayscale(frames).astype(np.float32) / 255.0
    video = NormalizeVideo()(video)
    video = CenterCrop(crop_size)(video)

    audio = None
    wav = os.path.splitext(video_path)[0] + ".wav"
    if os.path.isfile(wav):
        audio, sr = media.read_audio(wav)
        if sr != 16000:
            audio = media.resample_audio(audio, sr, 16000)
    if audio is not None:
        video = align_video_to_audio(video, audio)
    return video, audio, fps


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--video", default="media/macron_crop.mp4")
    parser.add_argument("--mode", choices=["ao", "vo", "av"], default="av")
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--tokenizer",
                        default="datasets/LRS3/tokenizerbpe256.json")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import torch

    from avec_tpu_torch.decode.greedy import CTCGreedySearchDecoder
    from avec_tpu_torch.models import zoo
    from avec_tpu_torch.train.checkpoint import load_checkpoint

    video, audio, _ = load_av_inputs(args.video)
    if args.mode in ("ao", "av") and audio is None:
        raise SystemExit(
            f"no {os.path.splitext(args.video)[0]}.wav next to the video; "
            "extract audio first (ffmpeg -i video.mp4 -ac 1 -ar 16000 out.wav)")

    device = zoo.resolve_device(args.device)
    as_t = lambda a: torch.as_tensor(a).to(device)
    if args.mode == "ao":
        model = zoo.AudioEfficientConformerInterCTC(interctc_blocks=(),
                                                    device=device)
        inputs = [audio[None], np.array([len(audio)], np.int32)]
    elif args.mode == "vo":
        model = zoo.VisualEfficientConformerInterCTC(device=device)
        inputs = [video[None], np.array([video.shape[0]], np.int32)]
    else:
        model = zoo.AudioVisualEfficientConformerInterCTC(device=device)
        inputs = [video[None], np.array([video.shape[0]], np.int32),
                  audio[None], np.array([len(audio)], np.int32)]
    if args.checkpoint and os.path.isfile(args.checkpoint):
        model.load_state_dict(
            load_checkpoint(args.checkpoint)["model_state_dict"])
    else:
        print("WARNING: no checkpoint loaded — transcription will be noise")

    with torch.inference_mode():
        logits, lengths = model(*(as_t(a) for a in inputs))["outputs"]
    if os.path.isfile(args.tokenizer):
        decoder = CTCGreedySearchDecoder(args.tokenizer)
        text = decoder(decoder.device_fn((logits, lengths)))[0]
        print(f"Transcription ({args.mode}): {text!r}")
    else:
        preds = logits.argmax(dim=-1)[0].cpu().numpy()
        print(f"No tokenizer at {args.tokenizer}; argmax token ids: "
              f"{preds[: int(lengths[0])]}")


if __name__ == "__main__":
    main()
