"""Plugin catalog discovery.

Same leaf schema as the reference platform (ref: scripts/pluginlib.py:105-262):
plugins/<Category>/<PluginKey>/plugin.json with name/slug/pluginCode(4)/
bundleId/clapId/clapFeatures/pluginType + entry source (.jsfx or .dsp) and a
leaf README.md embedded as help.  A catalog root can be any directory tree
— including the reference checkout itself — so users of the reference can
point this framework at their existing plugins unchanged.

Copy of zorak_tpu/catalog/discovery.py without `PluginSpec.load_program`,
which parses JSFX and comes with the port's JSFX slices.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

META_FILENAME = "plugin.json"
README_FILENAME = "README.md"
DEFAULT_MANUFACTURER = ("Zorak Audio", "Zrka")
DEFAULT_BUNDLE_BASE = "com.zorakaudio"
DEFAULT_CLAP_FEATURES = ("audio-effect",)


class CatalogError(RuntimeError):
    pass


@dataclass(frozen=True)
class PluginSpec:
    root_dir: Path
    meta_path: Path
    category: str
    key: str
    name: str
    slug: str
    plugin_code: str
    bundle_id: str
    clap_id: str
    clap_features: Tuple[str, ...]
    plugin_type: str                 # jsfx | faust
    entry_path: Path
    readme_path: Optional[Path]
    manufacturer_name: str = DEFAULT_MANUFACTURER[0]
    manufacturer_code: str = DEFAULT_MANUFACTURER[1]
    raw: Dict = field(default_factory=dict, hash=False, compare=False)

    def help_markdown(self) -> str:
        if self.readme_path and self.readme_path.is_file():
            return self.readme_path.read_text(encoding="utf-8", errors="replace")
        return ""


def _infer_entry(leaf: Path) -> Path:
    candidates = sorted(leaf.glob("src/*.jsfx")) + sorted(leaf.glob("src/*.dsp")) \
        + sorted(leaf.glob("*.jsfx")) + sorted(leaf.glob("*.dsp"))
    if not candidates:
        raise CatalogError(f"no .jsfx/.dsp entry found under {leaf}")
    return candidates[0]


def load_spec(meta_path: Path, plugins_root: Path) -> PluginSpec:
    leaf = meta_path.parent
    try:
        rel = leaf.relative_to(plugins_root)
    except ValueError as exc:
        raise CatalogError(f"plugin leaf must live under {plugins_root}") from exc
    if len(rel.parts) != 2:
        raise CatalogError(
            f"plugin metadata must sit at <Category>/<PluginKey>/{META_FILENAME}: {meta_path}")
    category, key = rel.parts

    try:
        data = json.loads(meta_path.read_text(encoding="utf-8"))
    except json.JSONDecodeError as exc:
        raise CatalogError(f"invalid JSON in {meta_path}: {exc}") from exc
    if not isinstance(data, dict):
        raise CatalogError(f"expected a JSON object in {meta_path}")

    name = str(data.get("name") or key).strip()
    slug = str(data.get("slug") or "").strip()
    code = str(data.get("pluginCode") or "").strip()
    if not slug:
        raise CatalogError(f"missing 'slug' in {meta_path}")
    if len(code) != 4:
        raise CatalogError(f"pluginCode must be 4 characters in {meta_path}: {code!r}")

    entry_value = str(data.get("entry") or "").strip()
    entry = (leaf / entry_value) if entry_value else _infer_entry(leaf)
    if not entry.exists():
        raise CatalogError(f"entry source missing: {entry}")

    ptype = str(data.get("pluginType") or "").strip().lower()
    if not ptype:
        ptype = "faust" if entry.suffix.lower() == ".dsp" else "jsfx"
    if ptype not in ("jsfx", "faust"):
        raise CatalogError(f"invalid pluginType {ptype!r} in {meta_path}")
    if ptype == "faust" and entry.suffix.lower() != ".dsp":
        raise CatalogError(f"faust entry must be .dsp: {meta_path}")
    if ptype == "jsfx" and entry.suffix.lower() != ".jsfx":
        raise CatalogError(f"jsfx entry must be .jsfx: {meta_path}")

    bundle_id = str(data.get("bundleId")
                    or f"{DEFAULT_BUNDLE_BASE}.{slug.lower()}").strip()
    clap_id = str(data.get("clapId") or bundle_id).strip()
    features_raw = data.get("clapFeatures") or list(DEFAULT_CLAP_FEATURES)
    if not isinstance(features_raw, list) or not all(
            isinstance(x, str) and x.strip() for x in features_raw):
        raise CatalogError(f"clapFeatures must be a list of strings: {meta_path}")

    readme = leaf / README_FILENAME
    return PluginSpec(
        root_dir=leaf,
        meta_path=meta_path,
        category=category,
        key=key,
        name=name,
        slug=slug,
        plugin_code=code,
        bundle_id=bundle_id,
        clap_id=clap_id,
        clap_features=tuple(x.strip() for x in features_raw),
        plugin_type=ptype,
        entry_path=entry,
        readme_path=readme if readme.is_file() else None,
        manufacturer_name=str(data.get("manufacturerName")
                              or DEFAULT_MANUFACTURER[0]).strip(),
        manufacturer_code=str(data.get("manufacturerCode")
                              or DEFAULT_MANUFACTURER[1]).strip(),
        raw=data,
    )


def discover(catalog_root: str | Path) -> List[PluginSpec]:
    """Find every leaf plugin.json under <root>/plugins (or <root> itself)."""
    root = Path(catalog_root)
    plugins_root = root / "plugins" if (root / "plugins").is_dir() else root
    metas = sorted(plugins_root.rglob(META_FILENAME))
    specs = [load_spec(m, plugins_root) for m in metas]
    if not specs:
        raise CatalogError(f"no {META_FILENAME} leaves under {plugins_root}")

    seen_slug: Dict[str, Path] = {}
    seen_clap: Dict[str, Path] = {}
    for s in specs:
        if s.slug in seen_slug:
            raise CatalogError(
                f"duplicate slug {s.slug!r}: {s.meta_path} vs {seen_slug[s.slug]}")
        if s.clap_id in seen_clap:
            raise CatalogError(
                f"duplicate clapId {s.clap_id!r}: {s.meta_path} vs {seen_clap[s.clap_id]}")
        seen_slug[s.slug] = s.meta_path
        seen_clap[s.clap_id] = s.meta_path
    return specs


def match(spec: PluginSpec, needle: str) -> bool:
    q = needle.strip().lower()
    if not q:
        return True
    return any(q in h.lower() for h in (
        spec.category, spec.slug, spec.name, spec.key,
        spec.bundle_id, spec.clap_id))


def select(specs: Iterable[PluginSpec], needle: str) -> List[PluginSpec]:
    return [s for s in specs if match(s, needle)]
