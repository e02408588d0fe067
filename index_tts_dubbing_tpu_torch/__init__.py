"""index_tts_dubbing_tpu_torch — the PyTorch/CUDA port of index_tts_dubbing_tpu.

The JAX package beside it is the reference this port is held against; the
module names and layout mirror it:

- ``config``  — the engine's configuration dataclasses and YAML loader.
- ``nn``      — functional layers over plain parameter dictionaries.
- ``weights`` — random initialisation and the bridge from JAX parameters.
- ``models``  — GPT decoder, conformer + perceiver conditioning, ECAPA.
- ``ops``     — mel frontend, anti-aliased activations and the two vocoder
                kernels (hand-written CUDA under ``csrc/``).
- ``engine``  — sampling decode, windowed vocoder and the ``IndexTTS`` engine.
- ``parallel`` — (data, model) meshes over torch.distributed: tensor
                parallelism for the GPT, data parallelism for the decode.
- ``training`` — the GPT train step (AdamW, JAX's npz state layout) and the
                vocoder's GAN and multi-scale mel losses.
- ``utils``   — text frontend and audio IO (host-only copies).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
