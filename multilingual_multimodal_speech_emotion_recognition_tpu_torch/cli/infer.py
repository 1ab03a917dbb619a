"""Single-sample inference CLI of the port (interface.main).

    python -m multilingual_multimodal_speech_emotion_recognition_tpu_torch.cli.infer \\
        --checkpoint ckpt_dir --audio clip.wav --text "..." [--use_tta] \\
        [--visualize fig.png] [--export results.json]

The flags are the repo's cli/infer.py's, with `--device` (default cuda) in
place of `--platform`; `--int8` quantises the backbones' encoder matmuls
(ops/quant.py). Without a card the CLI exits non-zero unless `--device cpu`
is given.
"""

from __future__ import annotations

import sys

from ..interface import main

if __name__ == "__main__":
    main(sys.argv[1:])
