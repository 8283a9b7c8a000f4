# Copy of image_transformation_tpu/vlm/personas.py (host-only; imports rewritten to this package).
"""Planner / Critic / Refiner persona prompt builders.

The reference drives three personas against one shared context block
(reference/macro_placement_test.py:21-148, 986-1330): a macro-level
Layout Planner (first draft, structure only), a Creative-Director Critic
(plain-text score + violations + minor-tweak plan, fixed temperature 0.3)
and a Layout Improver/Refiner (micro tweaks only, multi-turn with its own
previous JSON and the critique).

These builders produce the *message lists* for the client seam; they are
pure host string work. The contracts preserved exactly: message roles and
multi-turn shape, image ordering, JSON-only output rules, frozen-root and
micro-tweaks-only constraints, hard-constraint blocks (depth <= 2, exact
coverage, row/column nesting conflicts), and per-aspect-family guidance.

Note on wording: the prompt text itself is part of the behavioral surface
— the VLM's output distribution (and therefore golden parity of the whole
loop) depends on the exact phrasing, the same way it depends on the JSON
schema. The persona wording is therefore kept faithful to the reference's
as a protocol contract, not as implementation; all *code* here (context
assembly, role inference, summaries, message construction) is written
fresh against the TPU build's data structures.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

from ..layout.canvas import ratio_family


def best_practices_text(aspect_family: str) -> str:
    """Per-role, per-aspect-family placement heuristics."""
    return (
        "Best practices (macro placement):\n"
        "- photo: foreground image. Ratio type: Vertical: if only 1 image, avoid top. "
        "Square: if only 1 image, avoid top-left. Horizontal/U-wide: center vertically.\n"
        "- design element: drawn/geometric. Typically center vertically.\n"
        "- text: copy with font attributes. Ratio type: Vertical: center horizontally; "
        "Horizontal/U-wide: typically center vertically and often stacked below other objects.\n"
        "- composite image: composed of image/design/text.\n"
        "- logo: special composite (brand). Ratio type: Vertical: top or bottom or center "
        "if prominent. Square: near a corner or centered top/bottom or mid with prominence. "
        "Horizontal/U-wide: far left or right, sometimes central; typically centered vertically.\n"
        "- CTA: special composite (button-like) with design+verb text. Vertical/Square: "
        "lower half but not close to bottom; Square can be centered or slightly right. "
        "Horizontal: right half, not close to right margin; U-wide: centered vertically, "
        "toward right.\n"
        f"- Aspect family: {aspect_family}. Apply the corresponding guidance above."
    )


def infer_role(label: str) -> str:
    """Keyword role inference used in object summaries."""
    low = label.lower()
    if "logo" in low:
        return "logo"
    if "cta" in low:
        return "cta"
    if "text" in low or "copy" in low:
        return "text"
    if "design" in low or "shape" in low or "element" in low:
        return "design"
    return "image"


def object_summary_lines(
    items: List[dict], original_size: Tuple[int, int]
) -> Tuple[List[str], List[str]]:
    """(summary_lines, role_lines) with normalized original bboxes."""
    iw, ih = original_size
    summary, roles = [], []
    for it in items:
        oid = int(it["object_id"])
        label = it.get("label", "")
        role = infer_role(label)
        x1, y1, x2, y2 = it.get("bounding_box", [0, 0, 0, 0])
        nb = [
            round(x1 / max(1, iw), 4), round(y1 / max(1, ih), 4),
            round(x2 / max(1, iw), 4), round(y2 / max(1, ih), 4),
        ]
        summary.append(
            f"id={oid}, name='{label}', role={role}, bbox_norm=[{nb[0]},{nb[1]},{nb[2]},{nb[3]}]"
        )
        roles.append(f"{oid}:{role}")
    return summary, roles


def format_pairs(pairs: List[Tuple[str, str]]) -> str:
    return ", ".join(f"({a}, {b})" for a, b in pairs) or "none"


def shared_context_block(
    design_rules: str,
    summary_text: str,
    role_lines: List[str],
    row_bad_str: str,
    col_bad_str: str,
) -> str:
    """The CORE CONTEXT all three personas share: hard constraints,
    guiding principles, data reference, and the DSL schema."""
    return f"""### CORE CONTEXT

This section contains the data, rules, and schema you must adhere to.
1. Hard Constraints (Non-Negotiable)

    The layout's nesting depth MUST NOT exceed 2.

    Every object_id provided in the Data Reference MUST be used exactly once.

    The following pairs of objects are too large to fit together in the same container along the specified axis. This rule CANNOT be bypassed by grouping.

        Row Nesting Conflicts: {row_bad_str}

        Column Nesting Conflicts: {col_bad_str}

2. Guiding Principles (Aesthetic & Structural Advice)

{design_rules}

    Vertical Ratios: Prefer a single column. Preserve top-to-bottom reading order.

    Ultra-Wide/Horizontal Ratios: Prefer a single row. Preserve left-to-right flow.

    Square Ratios: Aim for a balanced, grid-like composition.

    Nesting: Avoid nesting unless it is clearly present in the original design.

3. Data Reference

    Objects Summary (id, name, role, original bbox_norm):
    {summary_text}

    Roles Map:
    {", ".join(role_lines)}

4. DSL Schema

Your JSON output must conform strictly to this structure.
{{
"root": {{
"type": "flex",
"direction": "row|column",
"justify": "start|center|end|space_between|space_around",
"align": "start|center|end",
"gap_px": int (optional),
"padding_px": int (optional),
"children": [ <item_or_container>, ... ]
}}
}}

    An <item> is: {{ "object_id": <int>, "name": "<string EXACT label>" }}

    A <container> is another flex object, subject to the depth limit."""


def _pick_rules(custom: Optional[str], ratio: str) -> str:
    if custom and custom.strip():
        return custom.strip()
    return best_practices_text(ratio_family(ratio))


def build_planner_messages(
    *,
    ratio: str,
    summary_text: str,
    role_lines: List[str],
    row_bad: List[Tuple[str, str]],
    col_bad: List[Tuple[str, str]],
    images_b64: List[str],
    planner_addendum: str = "",
    custom_design_rules: Optional[str] = None,
) -> Tuple[List[Dict], str, str]:
    """Planner persona. Returns (messages, prompt_text, best_practices).

    Images order: contact sheet, target-ratio canvas, original input.
    The planner works strictly at the macro level: no spacing/alignment
    properties, no extra containers, every object exactly once.
    """
    rules = _pick_rules(custom_design_rules, ratio)
    context = shared_context_block(
        rules, summary_text, role_lines, format_pairs(row_bad), format_pairs(col_bad)
    )
    prompt = f"""### PERSONA

You are a pragmatic Layout Planner.
TASK

Your goal is to generate a valid first-draft layout in the Flex DSL JSON format. Analyze the original image to understand its visual intent and use the object data as your guide. Your layout must fit within the provided target canvas.

IMPORTANT: You must work strictly at the MACRO level:
- You may only decide container directions (row/column) and which objects belong in each container.
- Do NOT set or mention any spacing or alignment properties (no gap_px, padding_px, justify, align, pin, offset, stick_to).
- Do NOT invent new containers beyond depth 2, and do not duplicate or drop objects.

{context}
OUTPUT INSTRUCTIONS

    Your output must be ONLY the valid JSON object.

    Do not include any explanations, comments, or markdown code fences.

ADDITIONAL GUIDANCE (optional):
{planner_addendum}
"""
    messages = [
        {
            "role": "system",
            "content": (
                "You are a JSON generator. Follow HARD CONSTRAINTS strictly. "
                "Output ONLY valid JSON matching the schema. No markdown, no explanations."
            ),
        },
        {"role": "user", "content": prompt, "images": images_b64},
    ]
    return messages, prompt, rules


def build_critic_messages(
    *,
    ratio: str,
    summary_text: str,
    role_lines: List[str],
    row_bad: List[Tuple[str, str]],
    col_bad: List[Tuple[str, str]],
    images_b64: List[str],
    best_practices: str,
    previous_critic_text: str = "",
    previous_refiner_json: Optional[Dict] = None,
    custom_design_rules: Optional[str] = None,
) -> Tuple[List[Dict], str]:
    """Critic persona (plain text out; fixed temperature 0.3 at call site).

    Multi-turn memory: when a previous round exists, the refiner's JSON is
    replayed as an assistant turn followed by the previous critique, so the
    critic can judge whether its feedback was addressed.
    """
    rules = custom_design_rules.strip() if (custom_design_rules and custom_design_rules.strip()) else best_practices
    context = shared_context_block(
        rules, summary_text, role_lines, format_pairs(row_bad), format_pairs(col_bad)
    )
    prompt = f"""### PERSONA

You are a professional Creative Director and a strict Design Critic.
TASK

Your goal is to evaluate the provided layout draft. Your primary focus is to determine how well the draft preserves the visual intent, balance, and core message of the original advertisement while adapting it to a new format. You must be specific, honest, and actionable. Do not generate a solution or JSON. If you are shown earlier conversation turns, use them to judge whether the latest refinement addressed your critique.

{context}
EVALUATION & OUTPUT INSTRUCTIONS

Analyze the draft and provide your critique structured into the following sections. Be concise but specific.

1. Overall Score (out of 10):

    A single number from 0 to 10. (10=Perfect, 7=Acceptable, <5=Major flaws).

2. Preservation of Original Intent:

    How well does the draft maintain the original's visual hierarchy?

    Is the focus on the correct elements (e.g., the product, the main message)?

    Does the new layout feel like a professional adaptation or a random assortment of parts?

3. Hard Constraint Violations:

    Did the layout violate any of the non-negotiable rules from the CORE CONTEXT?

    Name the specific objects and rules that were broken (e.g., "Violates Row Nesting Conflict: ('Logo', 'Main Image')").

4. Composition & Design Issues:

    Comment on balance, alignment, negative space, and visual flow.

    Is the logo placement appropriate? Is the Call-to-Action (CTA) prominent and logically placed?

    Are there any awkward gaps, crowded areas, or margin violations?

5. Actionable Improvement Plan:

    Provide a clear, imperative list of MINOR TWEAKS for the next agent. The refiner can ONLY adjust spacing, padding, and fine-tune positions - it CANNOT change container structure, direction, or reorder objects.
    - Address objects one by one, referencing both their label and object_id (e.g., "CTA (object_id 3)").
    - Focus on micro adjustments that preserve the macro structure.

    GOOD examples:
    - "Logo (object_id 5): Increase padding_px by 20 to separate it from the headline."
    - "Hero text (object_id 2): Add gap_px of 15 to its parent column to open vertical breathing room."
    - "CTA (object_id 3): Pin horizontally to center so it aligns with the logo."
    - "Body copy (object_id 4): Add offset_px y:-10 to pull it closer to the hero image."

    BAD examples (DO NOT suggest these):
    - "Change the root container's direction to 'column'"
    - "Create a nested row container"
    - "Swap the positions of objects"
    - "Reorder the children array" """

    messages: List[Dict] = [
        {
            "role": "system",
            "content": "You are a strict design critic. Output only plain text. Be concise and specific.",
        }
    ]
    if previous_critic_text and previous_refiner_json:
        messages.append({
            "role": "assistant",
            "content": json.dumps(previous_refiner_json, indent=2),
        })
        messages.append({"role": "user", "content": previous_critic_text})
    messages.append({"role": "user", "content": prompt, "images": images_b64})
    return messages, prompt


def build_refiner_messages(
    *,
    ratio: str,
    summary_text: str,
    role_lines: List[str],
    row_bad: List[Tuple[str, str]],
    col_bad: List[Tuple[str, str]],
    images_b64: List[str],
    prev_flex_json: Dict,
    critic_text: str,
    extra_instructions: str = "",
    refiner_addendum: str = "",
    custom_design_rules: Optional[str] = None,
) -> Tuple[List[Dict], str]:
    """Refiner persona: multi-turn (system, task+images, assistant=previous
    JSON, user=critique). Frozen root; micro tweaks only; validator errors
    are injected via ``extra_instructions`` on the retry path.
    """
    rules = _pick_rules(custom_design_rules, ratio)
    context = shared_context_block(
        rules, summary_text, role_lines, format_pairs(row_bad), format_pairs(col_bad)
    )

    task_sections = [
        "### ROLE\n\nYou are the Layout Improver.",
        "### OBJECTIVE\nYour job is to make MINOR adjustments to Flex JSON layouts. "
        "You fine-tune object placement, NOT redesign layouts.",
        context,
        "### STRICT RULES\n\n"
        "1. DO NOT CHANGE CONTAINER STRUCTURE:\n"
        "   - You MUST NOT change 'direction' (row/column) in ANY container, including root\n"
        "   - You MUST NOT add or remove containers\n"
        "   - You MUST NOT add or remove objects\n"
        "   - Do not reorder the children arrays\n\n"
        "2. ROOT CONTAINER IS FROZEN:\n"
        "   - No gap_px, padding_px, justify, or align changes at the root\n\n"
        "3. ALLOWED TWEAKS FOR NON-ROOT ITEMS:\n"
        "   - gap_px (only on non-root containers)\n"
        "   - padding_px (only on non-root containers)\n"
        "   - justify and align (only on non-root containers; preserve macro intent)\n"
        "   - Object-level padding_px, pin, offset_px, stick_to\n\n"
        '4. If feedback suggests structural changes (like "change direction to column"), '
        "IGNORE those. You only make micro adjustments.",
    ]
    if refiner_addendum:
        task_sections.append("### ADDITIONAL GUIDANCE\n" + refiner_addendum)
    initial_task = "\n\n".join(task_sections)
    initial_task += "\n\n### OUTPUT FORMAT\nReturn ONLY the JSON object—no prose, no markdown."

    prev_json_str = json.dumps(prev_flex_json, indent=2)

    feedback_sections = [
        "Here is the feedback from the Creative Director on your previous layout:",
        "",
        "### CRITIC'S EVALUATION",
        critic_text,
        "",
        "### YOUR TASK NOW",
        "Based on this critique, improve the layout JSON. Remember:",
        "- Only make MINOR tweaks (padding, gaps, pins, offsets)",
        "- Do NOT change container structure, direction, or object order",
        "- Address every specific point the critic raised",
        "- Return ONLY the improved JSON—no explanations",
    ]
    if extra_instructions:
        feedback_sections.append("\n### VALIDATION ERRORS (fix these strictly)")
        feedback_sections.append(extra_instructions)
    critic_feedback = "\n".join(feedback_sections)

    messages = [
        {
            "role": "system",
            "content": (
                "You are a Layout Improver. You iteratively refine Flex JSON "
                "layouts based on feedback. Follow constraints strictly. "
                "Output ONLY valid JSON."
            ),
        },
        {"role": "user", "content": initial_task, "images": images_b64},
        {"role": "assistant", "content": prev_json_str},
        {"role": "user", "content": critic_feedback},
    ]
    prompt_text = f"""=== CONVERSATION-BASED REFINEMENT ===

[USER - Initial Task]
{initial_task}

[ASSISTANT - Your Previous Output]
{prev_json_str}

[USER - Critic Feedback & Improvement Request]
{critic_feedback}
"""
    return messages, prompt_text
