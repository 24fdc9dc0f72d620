"""Style prompt templates for the FGIS evaluation sweep: the JAX
package's eval/styles.py, copied as data.

Named (positive, negative) template pairs applied around the sweep prompt
with a `{prompt}` placeholder (the reference's
evaluation/style_template.py:1-89). Style names match the reference so
sweep configs are interchangeable.
"""
from __future__ import annotations

from typing import Dict, Tuple

DEFAULT_STYLE = "Photographic (Default)"

_COMMON_NEG = ("lowres, bad anatomy, deformed face, mutated hands, blurry, "
               "watermark, text, jpeg artifacts")

STYLES: Dict[str, Tuple[str, str]] = {
    "(No style)": ("{prompt}", ""),
    "Photographic (Default)": (
        "photograph of {prompt}, sharp focus, natural light, high detail, "
        "85mm portrait",
        "drawing, painting, cartoon, 3d render, " + _COMMON_NEG),
    "Cinematic": (
        "cinematic still of {prompt}, film grain, dramatic lighting, "
        "anamorphic, shallow depth of field",
        "cartoon, sketch, flat lighting, " + _COMMON_NEG),
    "Digital Art": (
        "digital artwork of {prompt}, concept art, highly detailed, "
        "trending digital painting",
        "photograph, photorealistic, " + _COMMON_NEG),
    "Fantasy art": (
        "fantasy painting of {prompt}, epic scene, magical atmosphere, "
        "intricate detail, vivid",
        "photograph, modern, plain, " + _COMMON_NEG),
    "Neonpunk": (
        "neonpunk style {prompt}, cyberpunk neon glow, vibrant magenta and "
        "cyan, ultra detailed night city",
        "daylight, pastel, washed out, " + _COMMON_NEG),
    "Comic book": (
        "comic book panel of {prompt}, bold ink outlines, halftone shading, "
        "graphic novel coloring",
        "photograph, realistic skin, " + _COMMON_NEG),
    "Lowpoly": (
        "low-poly 3d render of {prompt}, faceted geometry, isometric, "
        "ambient occlusion, stylized",
        "photograph, high-detail texture, " + _COMMON_NEG),
    "Line art": (
        "clean line art drawing of {prompt}, single-weight ink lines, "
        "minimal shading, white background",
        "color, painting, photograph, " + _COMMON_NEG),
    "Watercolor": (
        "watercolor painting of {prompt}, soft washes, paper texture, "
        "delicate pigment blooms",
        "photograph, digital, sharp edges, " + _COMMON_NEG),
    "Vibrant Color": (
        "{prompt}, vivid saturated colors, bold palette, striking contrast, "
        "studio lighting",
        "monochrome, dull, washed out, " + _COMMON_NEG),
    "Enhance": (
        "{prompt}, best quality, ultra detailed, masterpiece, 8k",
        "worst quality, low quality, " + _COMMON_NEG),
    "Mars": (
        "{prompt} on the surface of Mars, red dust, rocky desert, "
        "thin atmosphere, sci-fi realism",
        "earth scenery, forest, ocean, " + _COMMON_NEG),
    "Jungle": (
        "{prompt} deep in a lush jungle, dense foliage, dappled sunlight, "
        "humid atmosphere",
        "desert, city, indoor, " + _COMMON_NEG),
    "Snow": (
        "{prompt} in a snowy landscape, falling snowflakes, cold blue light, "
        "winter clothing",
        "summer, beach, warm light, " + _COMMON_NEG),
    "Film Noir": (
        "film noir photograph of {prompt}, black and white, hard shadows, "
        "venetian-blind light, 1940s mood",
        "color, flat lighting, " + _COMMON_NEG),
    "Disney Charactor": (
        "3d animated character of {prompt}, big expressive eyes, soft "
        "rounded features, family-film render",
        "photograph, realistic, gritty, " + _COMMON_NEG),
}


def apply_style(style_name: str, prompt: str,
                negative: str = "") -> Tuple[str, str]:
    """Expand a style template around `prompt`; appends the user negative."""
    pos_t, neg_t = STYLES.get(style_name, STYLES[DEFAULT_STYLE])
    neg = (neg_t + ", " + negative).strip(", ") if negative else neg_t
    return pos_t.format(prompt=prompt), neg
