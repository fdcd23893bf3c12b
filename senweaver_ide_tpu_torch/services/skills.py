"""SkillService: named, on-demand instruction bundles.

Mirrors `common/skillService.ts` (522 LoC): skills live either in a
``skills.json`` config (name → {description, content}) or as
``<dir>/<name>/SKILL.md`` files (:99-100); the catalog (name +
description) is cheap and always available, full content loads on demand
when the policy calls the ``skill`` tool (:22-46). The catalog is rendered
into the system prompt; loading a skill injects its content into the
conversation as a tool result.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

SKILL_FILE_NAME = "SKILL.md"
SKILLS_CONFIG_FILE_NAME = "skills.json"


@dataclasses.dataclass
class SkillInfo:
    """SkillInfo (skillService.ts:22-27)."""
    name: str
    description: str
    location: str = ""
    content: Optional[str] = None        # loaded on demand


class SkillService:
    def __init__(self, skills_dir: Optional[str] = None):
        self.skills_dir = skills_dir
        self._skills: Dict[str, SkillInfo] = {}
        self.error: Optional[str] = None
        if skills_dir:
            self.reload()

    # -- discovery ---------------------------------------------------------
    def reload(self) -> None:
        self._skills.clear()
        self.error = None
        d = self.skills_dir
        if not d or not os.path.isdir(d):
            return
        cfg = os.path.join(d, SKILLS_CONFIG_FILE_NAME)
        if os.path.exists(cfg):
            try:
                with open(cfg) as f:
                    data = json.load(f)
                for name, v in data.get("skills", {}).items():
                    self._skills[name] = SkillInfo(
                        name=name, description=v.get("description", ""),
                        location=cfg, content=v.get("content"))
            except (OSError, json.JSONDecodeError) as e:
                self.error = f"skills.json: {e}"
        for entry in sorted(os.listdir(d)):
            md = os.path.join(d, entry, SKILL_FILE_NAME)
            if os.path.isfile(md) and entry not in self._skills:
                desc = self._first_heading_line(md)
                self._skills[entry] = SkillInfo(name=entry,
                                                description=desc,
                                                location=md)

    @staticmethod
    def _first_heading_line(path: str) -> str:
        try:
            with open(path) as f:
                for line in f:
                    s = line.strip().lstrip("#").strip()
                    if s:
                        return s[:200]
        except OSError:
            pass
        return ""

    def register(self, name: str, description: str, content: str) -> None:
        """Programmatic registration (tests, in-memory skills)."""
        self._skills[name] = SkillInfo(name=name, description=description,
                                       content=content)

    # -- access ------------------------------------------------------------
    def get_all_skills(self) -> List[SkillInfo]:
        return list(self._skills.values())

    def get_skill(self, name: str) -> Optional[SkillInfo]:
        return self._skills.get(name)

    def load_skill_content(self, name: str) -> Optional[str]:
        """loadSkillContent (skillService.ts:68): lazy file read."""
        info = self._skills.get(name)
        if info is None:
            return None
        if info.content is None and info.location and \
                os.path.isfile(info.location):
            try:
                info.content = open(info.location).read()
            except OSError:
                return None
        return info.content

    # -- integration -------------------------------------------------------
    def catalog_for_prompt(self) -> str:
        """The catalog section for the system message."""
        if not self._skills:
            return ""
        lines = ["# Skills",
                 "Load a skill's full instructions with the skill tool:"]
        for s in self._skills.values():
            lines.append(f"- {s.name}: {s.description}")
        return "\n".join(lines)

    def tool_handler(self, params: Dict) -> Dict:
        """Handler for ToolsService.register_handler('skill', ...)."""
        name = params.get("name", "")
        content = self.load_skill_content(name)
        if content is None:
            known = ", ".join(self._skills) or "(none)"
            raise KeyError(f"unknown skill: {name}. Available: {known}")
        return {"name": name, "content": content}
