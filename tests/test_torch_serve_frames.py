"""The serve CLI's encoder frames (ROADMAP Queue 3, F2): the reference
draws them in float32 (``launch/serve.py``), which under ``--preset
full``'s bf16 parameters promotes its whole encoder to float32.  The
port's CLI draws them in float32 too, so its full-preset whisper-base
encoder computes in float32 (on the card: the CUDA-core flash kernel) and
its decoder in bf16."""
import pytest

torch = pytest.importorskip("torch")

import _torch_port  # noqa: E402,F401  (one PyTorch thread per worker)

from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import whisper  # noqa: E402


def test_full_preset_whisper_encoder_runs_in_float32(monkeypatch):
    seen = []
    encode = whisper.WhisperModel.encode

    def spy(self, frames):
        memory = encode(self, frames)
        seen.append((self.dtype, frames.dtype, memory.dtype,
                     tuple(frames.shape)))
        return memory

    monkeypatch.setattr(whisper.WhisperModel, "encode", spy)
    out = serve.main(["--arch", "whisper-base", "--preset", "full",
                      "--device", "cpu", "--batch", "1", "--prompt-len", "2",
                      "--tokens", "2"])
    assert tuple(out.shape) == (1, 2)
    assert seen == [(torch.bfloat16, torch.float32, torch.float32,
                     (1, 1500, 512))]
