"""The kernel build's output naming, without nvcc: two builds into the
same directory at once (the ranks of a sequence-sharded run on one card)
must both end with the library in place. A stand-in compiler writes its
`-o` file after a pause, so the two builds overlap."""

import os
import stat
import threading

from repro_torch.kernels import build


def _fake_nvcc(tmp_path):
    path = tmp_path / "nvcc"
    path.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'sleep 0.3\necho built > "$2"\n')
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_concurrent_builds_into_one_directory_both_succeed(tmp_path, monkeypatch):
    nvcc = _fake_nvcc(tmp_path)
    monkeypatch.setattr(build, "find_nvcc", lambda: nvcc)
    out_dir = tmp_path / "kernels"
    errors = []

    def one():
        try:
            build.KernelLibraries(out_dir).build_all()
        except Exception as exc:          # recorded, then asserted empty
            errors.append(exc)

    threads = [threading.Thread(target=one) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    for name in build.SOURCES:
        assert build._lib_path(name, out_dir).read_text() == "built\n"
    assert not [p for p in os.listdir(out_dir) if p.endswith(".tmp.so")]
