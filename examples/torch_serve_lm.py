"""End-to-end serving on the PyTorch port: batched requests against a small
LM, then the enc-dec Whisper.

The counterpart of ``examples/serve_lm.py`` on ``repro_torch``: a reduced
qwen2-style model served in waves through the KV-cache decode path, then
the reduced Whisper (prefill encodes stub audio frames, decode runs the
decoder with cross-attention), both through
``repro_torch.launch.serve.main``, the production CLI.

Run: PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
(the card by default)
"""

import argparse

from repro_torch.launch import serve

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
args = ap.parse_args()

outputs = serve.main([
    "--arch", "qwen2-1.5b", "--reduced", "--device", args.device,
    "--requests", "12", "--batch", "4",
    "--prompt-len", "12", "--gen", "12", "--cache-cap", "32",
])
assert len(outputs) == 12 and all(len(o) == 12 for o in outputs.values())
print(f"served {len(outputs)} requests; first output tokens: {outputs[0][:8].tolist()}")

# whisper (enc-dec) serving: prefill encodes audio-frame stubs, decode runs
# the decoder with cross-attention
outputs = serve.main([
    "--arch", "whisper-base", "--reduced", "--device", args.device,
    "--requests", "4", "--batch", "2",
    "--prompt-len", "8", "--gen", "8", "--cache-cap", "16",
])
assert len(outputs) == 4 and all(len(o) == 8 for o in outputs.values())
print(f"whisper served {len(outputs)} requests ✓")
