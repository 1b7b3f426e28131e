"""Nothing the harness or a cell's reference loads is JAX or the JAX
package, compared by whole top-level names (the program's own name begins
with the JAX package's), and the reference loads nothing of the program."""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "efficient_features_tpu"}


def loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_program_load_no_jax():
    tops = loaded("import featbench.harness, featbench.control\n"
                  "import efficient_features_tpu_torch.api\n"
                  "import efficient_features_tpu_torch.ops.matcher\n"
                  "import efficient_features_tpu_torch.ops.ransac")
    assert "efficient_features_tpu_torch" in tops
    assert not tops & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    tops = loaded("import featbench.reference.features, "
                  "featbench.reference.hash_sift, "
                  "featbench.reference.patch, "
                  "featbench.reference.matching, "
                  "featbench.reference.geometry, featbench.check, "
                  "featbench.frames, featbench.roofline.stages")
    assert not tops & (FORBIDDEN | {"efficient_features_tpu_torch"})


def test_reference_sources_name_nothing_of_the_program():
    for src in (ROOT / "featbench" / "reference").glob("*.py"):
        text = src.read_text()
        assert "efficient_features_tpu" not in text, src
