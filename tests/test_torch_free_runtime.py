"""The runtime package must work without torch (README "Weights" claim)
and without tqdm (progress bars are optional).

The reference package hard-requires torch at import time (reference:
fad.py:1-30 imports torch to run the exported artifacts); this framework's
runtime path is JAX-only — torch is needed once, at dev time, inside
tools/extract_weights.py. That claim is structural (no `import torch`
anywhere under frechet_audio_distance_exported_tpu/) but nothing stopped a
future change from quietly adding a lazy torch import on the scoring path,
where `score()`'s -1 sentinel would swallow the ImportError per file and the
regression would surface as silently wrong behavior instead of a test
failure. These tests score a real corpus in a subprocess whose import system
refuses to load the named module at all.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

REPO_ROOT = Path(__file__).parent.parent

_CHILD = textwrap.dedent(
    """
    import sys

    BLOCKED = sys.argv[3]
    VERBOSE = sys.argv[4] == "1"

    class _Block:
        '''Meta-path hook: any import of BLOCKED anywhere fails loudly.'''

        def find_spec(self, name, path=None, target=None):
            if name == BLOCKED or name.startswith(BLOCKED + "."):
                raise ImportError(
                    f"{{BLOCKED}} import attempted on the runtime path "
                    f"(the framework must run without {{BLOCKED}})"
                )
            return None

    sys.meta_path.insert(0, _Block())

    import os

    os.environ["FAD_TPU_OFFLINE"] = "1"

    import jax

    jax.config.update("jax_platforms", "cpu")

    sys.path.insert(0, {repo!r})

    import numpy as np

    from frechet_audio_distance_exported_tpu import FrechetAudioDistance
    from frechet_audio_distance_exported_tpu.utils.audio_io import write_wav

    sr = 16000
    bg, ev = sys.argv[1], sys.argv[2]
    t = np.linspace(0, 1.2, int(sr * 1.2), dtype=np.float32)
    for d, scale in ((bg, 0.5), (ev, 0.45)):
        for i, freq in enumerate((440.0, 660.0)):
            clip = (np.sin(2 * np.pi * freq * t) * scale).astype(np.float32)
            write_wav(os.path.join(d, f"{{i}}.wav"), clip, sr)

    fad = FrechetAudioDistance(model_name="vggish", weights="random", verbose=VERBOSE)
    score = fad.score(bg, ev)
    # score() converts any internal error (including a swallowed per-file
    # ImportError that empties the embedding set) into -1; a real run of
    # these distinct corpora yields a positive finite score.
    assert score != -1, f"score failed under the {{BLOCKED}} import block"
    assert np.isfinite(score) and score > 0, score
    assert BLOCKED not in sys.modules
    print("BLOCK_FREE_OK", score)
    """
).format(repo=str(REPO_ROOT))


def _score_with_blocked_import(tmp_path, module: str, verbose: bool) -> None:
    bg, ev = tmp_path / "bg", tmp_path / "ev"
    bg.mkdir()
    ev.mkdir()
    r = subprocess.run(
        [sys.executable, "-c", _CHILD, str(bg), str(ev), module, "1" if verbose else "0"],
        capture_output=True,
        text=True,
        timeout=600,
        cwd=str(REPO_ROOT),
    )
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert "BLOCK_FREE_OK" in r.stdout, r.stdout


def test_score_runs_with_torch_imports_blocked(tmp_path):
    _score_with_blocked_import(tmp_path, "torch", verbose=False)


def test_score_runs_with_tqdm_imports_blocked(tmp_path):
    """verbose=True is where a progress bar would be shown: without tqdm it
    must score all the same, not return the -1 sentinel."""
    _score_with_blocked_import(tmp_path, "tqdm", verbose=True)
