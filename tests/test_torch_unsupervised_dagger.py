"""``pipelines.unsupervised.run`` against the JAX package's in the "dagger"
train mode (DAgger, then the plant fine-tune), float64 on the CPU, 1e-8:
the check of ``test_torch_unsupervised.py``, in a file of its own so that
neither file holds a test worker for long."""

from test_torch_unsupervised import check_mode


def test_torch_unsupervised_dagger_run_matches_jax(tmp_path, monkeypatch):
    check_mode("dagger", tmp_path, monkeypatch)
