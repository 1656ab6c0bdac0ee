"""The port's static analyzers (``python -m repro_torch.analysis``), as
``tests/test_analysis.py`` holds the reference's: every seeded fault is
flagged (a grid, a block or a shared-memory size past an H100's limits, a
head dim or an SSD length a ``.cu`` was not compiled for, an unlocked
cross-thread write, a leaked thread, a host sync in a hot module),
waivers suppress findings, and the port's real tree is clean.
"""

import dataclasses
import textwrap

import pytest

from repro_torch.analysis import run_all
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.analysis.common import Finding, apply_waivers
from repro_torch.analysis.concurrency_lint import lint_file, lint_tree
from repro_torch.analysis.kernel_audit import (Launch, _cases, audit_kernels,
                                               audit_launch)
from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import InputShape
from repro_torch.kernels import ops


def _rules(findings):
    return {f.rule for f in findings}


# ---------------------------------------------------------------------------
# kernel_audit

@pytest.mark.parametrize("launch,rule", [
    (Launch("fixture", (1, 70000, 1), 256, 0), "kernel-grid"),
    (Launch("fixture", (1, 1, 65536), 256, 0), "kernel-grid"),
    (Launch("fixture", (2 ** 31, 1, 1), 256, 0), "kernel-grid"),
    (Launch("fixture", (0, 1, 1), 256, 0), "kernel-grid"),
    (Launch("fixture", (1, 1, 1), 2048, 0), "kernel-threads"),
    (Launch("fixture", (1, 1, 1), 256, 232449), "kernel-smem"),
])
def test_kernel_audit_flags_launches_past_the_cards_limits(launch, rule):
    findings, table = audit_launch(launch)
    assert _rules(findings) == {rule} and not table["ok"]


def test_kernel_audit_passes_a_launch_at_the_limits():
    findings, table = audit_launch(Launch(
        "fixture", (2 ** 31 - 1, 65535, 65535), 1024, ops.MAX_SMEM_BYTES))
    assert findings == [] and table["ok"]


def test_kernel_audit_flags_what_the_kernels_were_not_compiled_for():
    cfg = dataclasses.replace(get_reduced_config("zamba2-2.7b"),
                              head_dim=96, ssm_head_dim=48)
    cases = list(_cases("fixture", cfg, InputShape("odd", 48, 2, "prefill")))
    bad = {kernel: why for kernel, _, _, why in cases if why}
    assert "head_dim 96" in bad["flash_attention"]
    assert "ssd head dim 48" in bad["ssd_chunk"]
    # 48 tokens: over one chunk of the reduced config's 16 and a multiple
    # of it; 40 is not
    assert "ssd_length" not in bad
    cases = _cases("fixture", get_reduced_config("zamba2-2.7b"),
                   InputShape("odd", 40, 2, "prefill"))
    assert any(k == "ssd_length" and why for k, _, _, why in cases)


def test_kernel_audit_flags_a_grid_the_card_refuses():
    """A decode at a batch past grid y's 65,535 rows is refused."""
    (launch, *_), = [ops.launch_geometry(
        "decode_attention", b=70000, h=8, kh=8, s=64, hd=64, bf16=True)]
    findings, _ = audit_launch(Launch("decode_attention", *launch))
    assert "kernel-grid" in _rules(findings)


def test_kernel_audit_real_kernels_clean_and_complete():
    findings, tables = audit_kernels(["qwen3-4b", "zamba2-2.7b"])
    assert findings == []
    kernels = {(t["arch"], t["kernel"]) for t in tables}
    assert {("qwen3-4b", k) for k in ("flash_attention", "decode_attention",
                                      "vtrace")} <= kernels
    assert ("zamba2-2.7b", "ssd_chunk") in kernels
    assert ("rl-agent", "vtrace") in kernels
    for t in tables:
        assert t["smem_bytes"] <= ops.MAX_SMEM_BYTES
        assert t["roofline"]["flops"] > 0


def test_ssd_smem_mirror_matches_the_wrappers_limit():
    # the Zamba2 chunk of 256 and the training chunk of 128 fit; the
    # chunk of the reference's sweep (L 128, N 128) too
    for length, n in ((256, 64), (128, 64), (128, 128)):
        assert 0 < ops.ssd_smem_bytes(length, n, 64) <= ops.MAX_SMEM_BYTES


# ---------------------------------------------------------------------------
# concurrency_lint

def _lint_snippet(tmp_path, source, *, hot=None):
    path = tmp_path / "snippet.py"
    path.write_text(textwrap.dedent(source))
    return lint_file(str(path), hot=hot)


def test_lint_flags_unlocked_cross_thread_write(tmp_path):
    findings = _lint_snippet(tmp_path, """
        import threading

        class Racy:
            def start(self):
                self._t = threading.Thread(target=self._loop)
                self._t.start()

            def _loop(self):
                self.count = 1 + getattr(self, "count", 0)

            def stop(self):
                self._t.join()

            def read(self):
                return self.count
        """, hot=False)
    assert "thread-shared-write" in _rules(findings)
    assert "thread-no-join" not in _rules(findings)


def test_lint_lock_guard_suppresses_shared_write(tmp_path):
    findings = _lint_snippet(tmp_path, """
        import threading

        class Locked:
            def start(self):
                self._lock = threading.Lock()
                self._t = threading.Thread(target=self._loop)
                self._t.start()

            def _loop(self):
                with self._lock:
                    self.count = 1

            def stop(self):
                self._t.join()

            def read(self):
                with self._lock:
                    return self.count
        """, hot=False)
    assert "thread-shared-write" not in _rules(findings)


def test_lint_flags_thread_without_join(tmp_path):
    findings = _lint_snippet(tmp_path, """
        import threading

        class Leaky:
            def start(self):
                self._t = threading.Thread(target=lambda: None)
                self._t.start()

            def stop(self):
                pass
        """, hot=False)
    assert "thread-no-join" in _rules(findings)


def test_lint_flags_torch_host_syncs_in_a_hot_module(tmp_path):
    findings = _lint_snippet(tmp_path, """
        import torch
        import torch as th

        def hot_loop(x):
            a = x.item()
            b = x.sum().cpu()
            c = x.tolist()
            d = x.detach().numpy()
            torch.cuda.synchronize()
            th.cuda.synchronize(x.device)
            return a, b, c, d, x.to("cpu", non_blocking=True)
        """, hot=True)
    assert [f.rule for f in findings] == ["host-sync"] * 6
    assert [f.line for f in findings] == [6, 7, 8, 9, 10, 11]


def test_lint_host_sync_only_in_the_hot_classes(tmp_path):
    source = """
        class Hot:
            def f(self, x):
                return x.item()

        class Cold:
            def f(self, x):
                return x.item()
        """
    findings = _lint_snippet(tmp_path, source, hot={"Hot"})
    assert [(f.rule, f.line) for f in findings] == [("host-sync", 4)]
    assert _lint_snippet(tmp_path, source, hot=False) == []


def test_waiver_suppresses_finding(tmp_path):
    findings = _lint_snippet(tmp_path, """
        def hot_loop(x):
            return x.cpu()  # analysis: ignore[host-sync]
        """, hot=True)
    findings = apply_waivers(findings)
    assert len(findings) == 1 and findings[0].waived
    unrelated = apply_waivers([Finding(
        rule="other-rule", file=str(tmp_path / "snippet.py"), line=3,
        message="x")])
    assert not unrelated[0].waived       # the waiver names another rule


def test_lint_real_tree_clean():
    findings = apply_waivers(lint_tree())
    assert [f for f in findings if not f.waived] == []


def test_cli_exits_zero_on_the_real_tree(tmp_path, capsys):
    assert analysis_main(["--report", str(tmp_path / "r.json")]) == 0
    out = capsys.readouterr().out
    assert "0 unwaived finding(s)" in out
    _, report = run_all(archs=["granite-moe-1b-a400m"])
    assert report["num_unwaived"] == 0 and report["kernel_tables"]
