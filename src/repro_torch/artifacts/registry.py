"""File-backed, versioned registry of policy artifacts.

Layout (one directory per artifact name, one per version):

    <root>/
        bench_model/
            v0001/artifact.json
            v0003/artifact.json
            LATEST              # "v0003", updated last, atomic rename
        sod/
            ...

Storage follows the checkpointer's durability discipline exactly: every
version is written to a dot-prefixed tmp directory and published with one
``os.rename`` (readers can never observe a partial artifact), the LATEST
pointer is itself rename-published *after* the version lands, and keep-k GC
never deletes the newest durable version. References are ``"name"``
(resolves through LATEST) or ``"name@v3"`` (pinned). The layout and the
file bytes are the reference package's, so one registry serves both.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import time
from typing import List, Optional, Tuple

from repro_torch.artifacts.artifact import PolicyArtifact

_VDIR_RE = re.compile(r"^v(\d{4,})$")
_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]*$")

# default registry root: overridable per-process so launch entrypoints and
# CI agree on one location without threading a flag everywhere
DEFAULT_ROOT_ENV = "RAPTOR_REGISTRY"
DEFAULT_ROOT = "artifacts"


def default_root() -> str:
    return os.environ.get(DEFAULT_ROOT_ENV, DEFAULT_ROOT)


def parse_ref(ref: str) -> Tuple[str, Optional[int]]:
    """``"bench_model@v3"`` -> ``("bench_model", 3)``; bare name -> latest."""
    name, sep, ver = ref.partition("@")
    if not sep:
        return name, None
    if not ver.startswith("v") or not ver[1:].isdigit():
        raise ValueError(
            f"bad artifact reference {ref!r}: expected 'name' or 'name@vN'")
    return name, int(ver[1:])


@dataclasses.dataclass(frozen=True)
class ArtifactRef:
    """A saved artifact's durable identity: what a checkpoint manifest
    records and a CLI flag names."""

    name: str
    version: int
    digest: str

    @property
    def ref(self) -> str:
        return f"{self.name}@v{self.version}"

    def to_json(self) -> dict:
        return {"name": self.name, "version": self.version,
                "digest": self.digest}

    @staticmethod
    def from_json(data: dict) -> "ArtifactRef":
        return ArtifactRef(name=str(data["name"]),
                           version=int(data["version"]),
                           digest=str(data["digest"]))


class Registry:
    """A directory of versioned :class:`PolicyArtifact` files.

    ``keep_k`` bounds versions per name (0 = keep everything); GC runs on
    save and, like the checkpointer, never removes the newest version.

    ``retries``/``backoff``: a reader that races a concurrent publisher can
    observe the torn window between the two save renames — a LATEST pointer
    naming a version whose ``artifact.json`` has not landed yet, or a
    ``.tmp_v*`` staging dir mid-publish. ``load`` retries with exponential
    backoff *only* while the name dir shows that in-flight state; a
    genuinely missing artifact still fails fast.
    """

    def __init__(self, root: Optional[str] = None, keep_k: int = 0,
                 retries: int = 3, backoff: float = 0.05):
        self.root = root if root is not None else default_root()
        self.keep_k = keep_k
        self.retries = retries
        self.backoff = backoff
        os.makedirs(self.root, exist_ok=True)

    # ---- paths -------------------------------------------------------------
    def _name_dir(self, name: str) -> str:
        return os.path.join(self.root, name)

    def _version_dir(self, name: str, version: int) -> str:
        return os.path.join(self._name_dir(name), f"v{version:04d}")

    def path(self, name: str, version: int) -> str:
        return os.path.join(self._version_dir(name, version), "artifact.json")

    # ---- enumeration -------------------------------------------------------
    def names(self) -> List[str]:
        return sorted(
            d for d in os.listdir(self.root)
            if os.path.isdir(self._name_dir(d)) and not d.startswith("."))

    def versions(self, name: str) -> List[int]:
        base = self._name_dir(name)
        if not os.path.isdir(base):
            return []
        out = []
        for d in os.listdir(base):
            m = _VDIR_RE.match(d)
            if m and os.path.exists(os.path.join(base, d, "artifact.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_version(self, name: str) -> Optional[int]:
        """The LATEST pointer if durable, else the newest on-disk version
        (pointer write is the last step of save, so a crash between the
        two renames leaves a valid registry that self-heals here)."""
        ptr = os.path.join(self._name_dir(name), "LATEST")
        if os.path.exists(ptr):
            with open(ptr) as f:
                m = _VDIR_RE.match(f.read().strip())
            if m and os.path.exists(self.path(name, int(m.group(1)))):
                return int(m.group(1))
        vs = self.versions(name)
        return vs[-1] if vs else None

    # ---- save / load -------------------------------------------------------
    def save(self, artifact: PolicyArtifact,
             name: Optional[str] = None) -> ArtifactRef:
        """Publish a new version atomically; returns its durable ref.

        Every artifact is linted before publication
        (:func:`repro_torch.analysis.lint.lint_artifact`): error-level findings
        raise :class:`repro_torch.analysis.lint.ArtifactLintError` and block the
        save; warnings are recorded in the published artifact's provenance
        under ``"lint_warnings"``."""
        artifact = self._lint(artifact)
        name = name or artifact.name
        if not _NAME_RE.match(name or ""):
            raise ValueError(f"bad artifact name {name!r}")
        base = self._name_dir(name)
        os.makedirs(base, exist_ok=True)
        version = (self.latest_version(name) or 0) + 1
        while os.path.exists(self._version_dir(name, version)):
            version += 1
        tmp = os.path.join(base, f".tmp_v{version:04d}_{os.getpid()}")
        os.makedirs(tmp, exist_ok=True)
        text = artifact.dumps()
        with open(os.path.join(tmp, "artifact.json"), "w") as f:
            f.write(text)
        os.rename(tmp, self._version_dir(name, version))  # atomic publish
        ptr_tmp = os.path.join(base, f".LATEST_tmp_{os.getpid()}")
        with open(ptr_tmp, "w") as f:
            f.write(f"v{version:04d}")
        os.rename(ptr_tmp, os.path.join(base, "LATEST"))
        self._gc(name)
        return ArtifactRef(name=name, version=version,
                           digest=artifact.digest)

    @staticmethod
    def _lint(artifact: PolicyArtifact) -> PolicyArtifact:
        """Structural lint gate for publication. Clean artifacts pass
        through untouched (identical bytes, identical digest); warning
        findings are stamped into provenance so the published version
        carries its own lint report."""
        from repro_torch.analysis.lint import (ArtifactLintError,
                                               lint_artifact)
        findings = lint_artifact(artifact)
        if any(f.level == "error" for f in findings):
            raise ArtifactLintError(findings)
        if findings:
            prov = dict(artifact.provenance)
            prov["lint_warnings"] = [f.render() for f in findings]
            artifact = dataclasses.replace(artifact, provenance=prov)
        return artifact

    def _publish_in_flight(self, name: str) -> bool:
        """True if the name dir shows a concurrent publisher's torn window:
        a LATEST pointer naming a version whose ``artifact.json`` has not
        landed, or an unpublished staging dir/pointer tmp."""
        base = self._name_dir(name)
        if not os.path.isdir(base):
            return False
        ptr = os.path.join(base, "LATEST")
        if os.path.exists(ptr):
            with open(ptr) as f:
                m = _VDIR_RE.match(f.read().strip())
            if m and not os.path.exists(self.path(name, int(m.group(1)))):
                return True
        return any(d.startswith(".tmp_v") or d.startswith(".LATEST_tmp")
                   for d in os.listdir(base))

    def _load_once(self, name: str, version: Optional[int]) -> PolicyArtifact:
        if version is None:
            version = self.latest_version(name)
            if version is None:
                known = ", ".join(self.names()) or "<empty registry>"
                raise FileNotFoundError(
                    f"no artifact named {name!r} in registry {self.root!r} "
                    f"(known: {known})")
        path = self.path(name, version)
        if not os.path.exists(path):
            have = self.versions(name)
            raise FileNotFoundError(
                f"artifact {name}@v{version} not in registry {self.root!r} "
                f"(versions on disk: {have or 'none'})")
        with open(path) as f:
            return PolicyArtifact.loads(f.read())

    def load(self, ref: str) -> PolicyArtifact:
        """Load ``"name"`` (latest) or ``"name@vN"`` (pinned), with bounded
        retry/backoff while a concurrent publisher's rename window is
        visibly open (see class docstring)."""
        name, version = parse_ref(ref)
        delay = self.backoff
        for attempt in range(self.retries + 1):
            try:
                return self._load_once(name, version)
            except FileNotFoundError:
                if attempt >= self.retries or not self._publish_in_flight(name):
                    raise
                time.sleep(delay)
                delay *= 2
        raise AssertionError("unreachable")  # pragma: no cover

    def load_ref(self, ref: str) -> Tuple[PolicyArtifact, ArtifactRef]:
        """Load plus the resolved durable identity (digest recomputed from
        the stored bytes, so a tampered file is detectable upstream)."""
        name, version = parse_ref(ref)
        if version is None:
            version = self.latest_version(name)
        art = self.load(ref)
        return art, ArtifactRef(name=name, version=int(version),
                                digest=art.digest)

    def digest(self, ref: str) -> str:
        return self.load(ref).digest

    def _gc(self, name: str) -> None:
        if not self.keep_k:
            return
        for v in self.versions(name)[:-self.keep_k]:
            shutil.rmtree(self._version_dir(name, v), ignore_errors=True)


def load_artifact_file(path: str) -> PolicyArtifact:
    """Load one artifact from a bare ``.json`` file — the committed-to-git
    form the CI policy-drift gate diffs against (``artifacts/<name>.json``
    at the repo root is a plain file, not a registry tree)."""
    with open(path) as f:
        return PolicyArtifact.loads(f.read())


def save_artifact_file(artifact: PolicyArtifact, path: str) -> None:
    """Atomically write one artifact as a bare ``.json`` file (pretty-printed
    but canonical-ordered, so git diffs stay readable and stable)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp_{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(artifact.to_json(), f, sort_keys=True, indent=2)
        f.write("\n")
    os.replace(tmp, path)


__all__ = ["Registry", "ArtifactRef", "parse_ref", "default_root",
           "load_artifact_file", "save_artifact_file"]
