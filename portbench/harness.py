"""The benchmark's cells: set-up, the measured window and the check.

A cell is found by its name in ``BENCHMARK.json``: its configuration's file
(``configs/<name>.json``: genome, bwa mem settings), its traffic
(``traffic/<name>.json``), its limits (``cells/<workload>.json``) and the
readers of its per-layer metrics (``metrics/<metric>.py``).  Nothing here
names a configuration, a mix or a metric.

The window drives the port's public entries as ``tpu-bwa-torch mem`` does:
``run_se_pipeline`` or ``align_pe_fastq`` with one worker (the
dispatch-ahead driver), reading FASTQ from named pipes that a producer
process (``portbench.producer``) fills with fresh reads, and writing SAM
into an in-memory sink.

Caches, inside the checkout, at fixed paths under ``build/portbench/``:
the genome's index text (``genome/<config>-<key>.npy``, keyed by the
genome's entry and the generator's source) and the port's index
(``index/<config>-<key>/``, keyed by that and by the port's index sources),
built once by the port's own ``FMIndex.from_fasta`` / ``save`` and loaded by
``FMIndex.load`` in every later run.
"""
from __future__ import annotations

import contextlib
import hashlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
WINDOW_STREAM, WARM_STREAM = 0, 1
FORBIDDEN = {"jax", "jaxlib", "flax", "tpubwa", "bench"}


def forbidden_modules() -> list[str]:
    """Loaded modules of the JAX package, JAX, Flax, the root bench.py or
    the port's tools (top-level names compared whole)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN
                  or m == "tpubwa_torch.tools"
                  or m.startswith("tpubwa_torch.tools."))


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One entry of ``workloads`` with everything it names."""

    def __init__(self, workload: str, root: Path = ROOT):
        self.root = Path(root)
        self.bench = _json(self.root / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.name = workload
        self.entry = cells[workload]
        cfgs = {c["name"]: c for c in self.bench["configs"]}
        self.config_name = self.entry["config"]
        self.config = _json(self.root / cfgs[self.config_name]["file"])
        self.traffic_path = (self.root / "portbench" / "traffic"
                             / f"{self.entry['traffic']}.json")
        self.traffic = _json(self.traffic_path)
        self.limits = _json(self.root / "portbench" / "cells"
                            / f"{workload}.json")["limits"]
        self.end_to_end = [m for m in self.bench["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        self.per_layer = [m for m in self.bench["per_layer"]
                          if workload in m.get("workloads", [workload])]
        self.build = self.root / "build" / "portbench"

    # ---------------------------------------------------------- set-up --

    def genome(self) -> tuple[Path, dict]:
        """The index text's cache file (made when absent) and the seconds
        it took to make it (empty when it was there)."""
        spec = self.config["genome"]
        key = hashlib.sha256(
            json.dumps(spec, sort_keys=True).encode()
            + (HERE / "gen" / "genomes.py").read_bytes()).hexdigest()[:16]
        path = self.build / "genome" / f"{self.config_name}-{key}.npy"
        built = {}
        if not path.exists():
            from portbench.gen.genomes import index_text, make_genome

            t = time.monotonic()
            codes, mask = make_genome(spec)
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(".tmp.npy")
            np.save(tmp, index_text(codes, mask))
            os.replace(tmp, path)
            built["genome_s"] = time.monotonic() - t
        self.genome_key = key
        return path, built

    def index(self) -> tuple[str, dict]:
        """The port's index of the genome (built and saved when absent):
        its prefix and the seconds the build took."""
        import tpubwa_torch
        from portbench.gen.genomes import make_genome, write_fasta

        pkg = Path(tpubwa_torch.__file__).resolve().parent
        h = hashlib.sha256(self.genome_key.encode())
        for src in sorted([*pkg.glob("index/*.py"), pkg / "native/sais.cpp",
                           pkg / "io/fasta.py", pkg / "utils/dna.py"]):
            h.update(src.name.encode() + src.read_bytes())
        d = self.build / "index" / f"{self.config_name}-{h.hexdigest()[:16]}"
        prefix = d / "ref.fa"
        built = {}
        if not (d / "ref.fa.tpubwa.json").exists():
            from tpubwa_torch.index.fmindex import FMIndex

            t = time.monotonic()
            tmp = d.with_name(d.name + ".tmp")
            shutil.rmtree(tmp, ignore_errors=True)
            tmp.mkdir(parents=True)
            codes, mask = make_genome(self.config["genome"])
            fa = tmp / "ref.fa"
            write_fasta(str(fa), codes, mask, self.config["genome"]["contig"])
            del codes, mask
            FMIndex.from_fasta(str(fa)).save(str(fa))
            fa.unlink()
            shutil.rmtree(d, ignore_errors=True)
            os.replace(tmp, d)
            built["index_s"] = time.monotonic() - t
        return str(prefix), built

    def mem_options(self, overrides: dict | None = None):
        from tpubwa_torch.config import MemOptions

        kw = dict(self.config["mem_options"])
        kw.update(overrides or {})
        return MemOptions(**kw)

    # ---------------------------------------------------------- window --

    def producer(self, text: Path, tmp: Path, seed: int, stream: int,
                 seconds: float, batches: int | None = None):
        """Start a producer on new pipes in `tmp`: (process, pipe paths)."""
        ends = int(self.traffic["ends"])
        fifos = []
        for e in range(ends):
            p = tmp / f"s{stream}_r{e + 1}.fq"
            os.mkfifo(p)
            fifos.append(str(p))
        cmd = [sys.executable, "-m", "portbench.producer", "--text",
               str(text), "--traffic", str(self.traffic_path), "--seed",
               str(seed), "--stream", str(stream), "--seconds", str(seconds)]
        if batches is not None:
            cmd += ["--batches", str(batches)]
        env = dict(os.environ, OMP_NUM_THREADS="1")
        env["PYTHONPATH"] = os.pathsep.join(
            [str(HERE.parent)] + ([env["PYTHONPATH"]]
                                  if env.get("PYTHONPATH") else []))
        proc = subprocess.Popen(cmd + fifos, stdout=subprocess.PIPE,
                                cwd=str(self.root), env=env)
        return proc, fifos

    def drive(self, aligner, fifos: list[str], sink) -> None:
        """The port's entry on the pipes, one worker."""
        if int(self.traffic["ends"]) == 1:
            from tpubwa_torch.align.pipeline import run_se_pipeline

            run_se_pipeline(aligner, fifos[0], sink, workers=1)
        else:
            from tpubwa_torch.align.pair import align_pe_fastq

            rc = align_pe_fastq(aligner, fifos[0], fifos[1], sink, workers=1)
            if rc != 0:
                raise RuntimeError(f"align_pe_fastq returned {rc}")


class Sink:
    """The SAM text the entry writes, kept in memory with the time of the
    last write."""

    def __init__(self):
        self.parts: list[str] = []
        self.times: list[float] = []
        self.t_last = None

    def write(self, s: str) -> int:
        self.parts.append(s)
        self.t_last = time.monotonic()
        self.times.append(self.t_last)
        return len(s)

    def text(self) -> str:
        return "".join(self.parts)


def finish_producer(proc) -> dict:
    """Wait for a producer and read its record."""
    out, _ = proc.communicate(timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"producer exited {proc.returncode}")
    return json.loads(out.decode().strip().splitlines()[-1])


@contextlib.contextmanager
def pipes_dir():
    """A directory for the pipes under TMPDIR, removed afterwards."""
    d = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        yield d
    finally:
        shutil.rmtree(d, ignore_errors=True)


def run_window(cell: Cell, aligner, text: Path, seed: int, seconds: float,
               trace: bool = False, proc_fifos=None) -> dict:
    """One measured window: fresh reads for `seconds`, then the drain.
    ``proc_fifos`` is a producer started ahead (in set-up)."""
    from portbench.trace import PhaseClock, WINDOW_RANGE, device_record

    import torch

    cuda = aligner.device.type == "cuda"
    with contextlib.ExitStack() as stack:
        if proc_fifos is None:
            tmp = stack.enter_context(pipes_dir())
            proc_fifos = cell.producer(text, tmp, seed, WINDOW_STREAM,
                                       seconds)
        proc, fifos = proc_fifos
        sink = Sink()
        clock = PhaseClock(profile=trace)
        aligner.timers = clock
        prof = None
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        try:
            rng = (torch.profiler.record_function(WINDOW_RANGE) if trace
                   else contextlib.nullcontext())
            with rng:
                cell.drive(aligner, fifos, sink)
                if cuda:
                    torch.cuda.synchronize()
        except BaseException:
            proc.kill()
            proc.wait()
            raise
        finally:
            if prof is not None:
                prof.stop()
        rep = finish_producer(proc)
    rec = {"text": sink.text(), "t_first": rep["t_first"],
           "t_last": sink.t_last, "batches": rep["batches"],
           "offered": rep["reads"], "starved_s": rep["starved_s"],
           "clock": clock}
    rec["window_s"] = rec["t_last"] - rec["t_first"]
    rec["batch_s"] = np.diff([rec["t_first"], *sink.times]).tolist()
    if prof is not None:
        rec["device"] = device_record(prof)
    return rec


def layer_record(rec: dict, reads: int) -> dict:
    """What the per-layer readers read: reads, the window, each phase's
    seconds, the seconds outside every phase, and the device's numbers."""
    from portbench.trace import union_length

    clock = rec["clock"]
    spans = np.array([(max(a, rec["t_first"]), min(b, rec["t_last"]))
                      for _, a, b in clock.spans], dtype=float).reshape(-1, 2)
    spans = spans[spans[:, 1] > spans[:, 0]]
    out = {"reads": reads, "window_s": rec["window_s"],
           "phase_s": dict(clock.totals), "phase_n": dict(clock.counts),
           "unphased_s": rec["window_s"] - union_length(spans)}
    if "device" in rec:
        out["device"] = rec["device"]
    return out


def read_metric(root: Path, name: str, record: dict):
    """The per-layer metric `name` from its reader ``metrics/<name>.py``:
    a number, or None where the run has nothing for it to read."""
    path = Path(root) / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{abs(hash(name))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(record)
