"""Build the HTML documentation site into site/ (the C23 docs target).

Renders README.md, docs/*.md, and the top-level reports (BASELINE, PARITY)
with python-markdown into a small static site with an index — rso's equivalent of the reference's doxygen/gh-pages task (.travis.sh:24-61)
without network or doxygen dependencies.

Usage: python tools/build_docs.py [--out site/]
"""
import argparse
import html
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PAGES = [
    ("index", "README.md", "Overview"),
    ("architecture", "docs/ARCHITECTURE.md", "Architecture"),
    ("modes", "docs/MODES.md", "Mode matrix & envelopes"),
    ("perf", "PERF.md", "Performance on the GPU"),
    ("gui", "docs/GUI.md", "GUI & live view"),
    ("marginalization", "docs/MARGINALIZATION.md", "Marginalization study"),
    ("flow-fault", "docs/FLOW_SCAN_FAULT.md", "Flow-mode scan fault"),
    ("baseline", "BASELINE.md", "Performance baseline"),
    ("parity", "PARITY.md", "Reference parity map"),
]

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8">
<title>rso — {title}</title>
<style>
 body {{ font: 15px/1.5 system-ui, sans-serif; max-width: 60rem;
        margin: 2rem auto; padding: 0 1rem; color: #1a1a1a; }}
 pre, code {{ background: #f5f5f5; border-radius: 4px; }}
 pre {{ padding: .8rem; overflow-x: auto; }}
 code {{ padding: .1rem .3rem; }}
 table {{ border-collapse: collapse; }}
 th, td {{ border: 1px solid #ccc; padding: .3rem .6rem; }}
 nav a {{ margin-right: 1rem; }}
</style></head><body>
<nav>{nav}</nav>
<hr>
{body}
</body></html>
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "site"))
    args = ap.parse_args()

    try:
        import markdown

        def render(text):
            return markdown.markdown(text, extensions=["tables",
                                                        "fenced_code"])
    except ImportError:  # minimal fallback: preformatted text
        def render(text):
            return f"<pre>{html.escape(text)}</pre>"

    os.makedirs(args.out, exist_ok=True)
    nav = " | ".join(f'<a href="{slug}.html">{title}</a>'
                     for slug, _, title in PAGES)
    built = []
    for slug, rel, title in PAGES:
        src = os.path.join(ROOT, rel)
        if not os.path.exists(src):
            continue
        with open(src) as f:
            body = render(f.read())
        with open(os.path.join(args.out, f"{slug}.html"), "w") as f:
            f.write(_TEMPLATE.format(title=title, nav=nav, body=body))
        built.append(slug)
    print(f"built {len(built)} pages into {args.out}: {', '.join(built)}")
    return 0 if built else 1


if __name__ == "__main__":
    raise SystemExit(main())
