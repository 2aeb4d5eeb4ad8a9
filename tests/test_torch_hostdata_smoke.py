"""chip_smoke.py's hostdata phase rehearsed on the CPU at a tiny size (the
CPU as the card): the JPEG dataset, the host loader's library, the decode
check, the three CLI runs (host chain, native loader, the cached rerun),
the host step card vs CPU, and the daemon's native and PIL masks,
/reload under concurrent clients, --watch and /metrics. No kernel
launches here; the step timings run on the card only."""

import chip_smoke as C


def test_hostdata_phase_rehearses_on_the_cpu(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(C, "DEVICE", "cpu")
    monkeypatch.setattr(C, "TRAIN", dict(
        model_type="ResUNet", base_filters=4, depth=2, image_size=32,
        batch_size=16, epochs=1))
    monkeypatch.setattr(C, "HOSTDATA_SPLITS", {
        "train": ((60, 48, 8), (96, 64, 8)),
        "val": ((60, 48, 4), (96, 64, 4)),
        "test": ((60, 48, 8), (96, 64, 8))})
    monkeypatch.setattr(C, "HOSTDATA_STEP", (32, 2))
    monkeypatch.setattr(C, "SLICE", dict(in_channels=1, out_channels=1,
                                         base_filters=4, depth=3,
                                         image_size=64))
    monkeypatch.setattr(C, "BATCH", 4)
    monkeypatch.setattr(C, "HOSTDATA_POSTS", 4)
    monkeypatch.setattr(C, "HOSTDATA_CLIENTS", 3)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)  # one core, beside the other test workers
    try:
        got = C.run_hostdata(str(tmp_path))
    finally:
        torch.set_num_threads(n)
    assert got["library"]["decode"] and got["decode"]["max_diff"] <= 1
    assert got["runs"]["launches"] == {"host_augment": 0,
                                       "native_loader": 0,
                                       "native_cached": 0}
    assert got["step"]["term_rel"] == 0.0  # the CPU against itself
    assert got["daemon"]["agree"] >= C.HOSTDATA_AGREE
    assert "steps" not in got
    out = capsys.readouterr().out
    assert "from the .store_cache" in out
    assert "equal JAX's True" in out and "mask changed True" in out
