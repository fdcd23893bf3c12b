"""SCM service: AI-generated git commit messages.

Counterpart of the reference's GenerateCommitMessageService
(browser/senweaverSCMService.ts, 230 LoC) + its main-process git helper
(electron-main/senweaverSCMMainService.ts). Semantics kept exactly:

- staged changes are preferred over the working tree when any exist
  (senweaverSCMMainService.ts hasStagedChanges)
- context = diff --stat, sampled per-file diffs of the top
  MAX_DIFF_FILES=10 files by added+removed lines with each diff capped
  at MAX_DIFF_LENGTH=8000 chars (unified=0), current branch, and the
  last 5 non-merge commits (%h|%s|%ad)
- the model answers in <output>/<reasoning> tags; the commit message is
  the <output> body (senweaverSCMService.ts onFinalMessage regex)

The prompt texts are ported as semantic fixtures
(prompts.ts:1724 gitCommitMessage_systemMessage, :1770
gitCommitMessage_userMessage) — same category as the APO gradient
prompts SURVEY.md §7 step 4 mandates porting verbatim.
"""

from __future__ import annotations

import re
import subprocess
from typing import List, Optional, Tuple

from ..agents.llm import ChatMessage, PolicyClient

MAX_DIFF_LENGTH = 8000    # senweaverSCMMainService.ts:19
MAX_DIFF_FILES = 10       # senweaverSCMMainService.ts:20

COMMIT_MESSAGE_SYSTEM = """\
You are an expert software engineer AI assistant responsible for writing \
clear and concise Git commit messages that summarize the **purpose** and \
**intent** of the change. Try to keep your commit messages to one \
sentence. If necessary, you can use two sentences.

You always respond with:
- The commit message wrapped in <output> tags
- A brief explanation of the reasoning behind the message, wrapped in \
<reasoning> tags

Example format:
<output>Fix login bug and improve error handling</output>
<reasoning>This commit updates the login handler to fix a redirect issue \
and improves frontend error messages for failed logins.</reasoning>

Do not include anything else outside of these tags.
Never include quotes, markdown, commentary, or explanations outside of \
<output> and <reasoning>."""


def commit_message_user_prompt(stat: str, sampled_diffs: str, branch: str,
                               log: str) -> str:
    """gitCommitMessage_userMessage (prompts.ts:1770)."""
    return f"""\
Based on the following Git changes, write a clear, concise commit message \
that accurately summarizes the intent of the code changes.

Section 1 - Summary of Changes (git diff --stat):

{stat}

Section 2 - Sampled File Diffs (Top changed files):

{sampled_diffs}

Section 3 - Current Git Branch:

{branch}

Section 4 - Last 5 Commits (excluding merges):

{log}"""


def extract_commit_message(full_text: str) -> str:
    """The <output> body (senweaverSCMService.ts onFinalMessage)."""
    m = re.search(r"<output>([\s\S]*?)</output>", full_text, re.I)
    return m.group(1).strip() if m else ""


class GitRepo:
    """Thin shell-out layer (the senweaverSCMMainService.ts role)."""

    def __init__(self, path: str):
        self.path = path

    def _git(self, *args: str) -> str:
        proc = subprocess.run(["git", *args], cwd=self.path,
                              capture_output=True, text=True, timeout=30)
        if proc.returncode != 0:
            raise RuntimeError(proc.stderr.strip()
                               or f"git {' '.join(args)} failed")
        return proc.stdout.strip()

    def has_staged_changes(self) -> bool:
        return bool(self._git("diff", "--staged", "--name-only"))

    def stat(self, staged: bool) -> str:
        return self._git("diff", "--stat",
                         *(["--staged"] if staged else []))

    def numstat(self, staged: bool) -> List[Tuple[str, int]]:
        """[(file, added+removed)] for changed files."""
        out = self._git("diff", "--numstat",
                        *(["--staged"] if staged else []))
        rows: List[Tuple[str, int]] = []
        for line in out.split("\n"):
            parts = line.split("\t")
            if len(parts) != 3:
                continue
            added = int(parts[0]) if parts[0].isdigit() else 0
            removed = int(parts[1]) if parts[1].isdigit() else 0
            rows.append((parts[2], added + removed))
        return rows

    def sampled_diff(self, file: str, staged: bool) -> str:
        diff = self._git("diff", "--unified=0", "--no-color",
                         *(["--staged"] if staged else []), "--", file)
        return diff[:MAX_DIFF_LENGTH]

    def branch(self) -> str:
        return self._git("branch", "--show-current")

    def log(self) -> str:
        return self._git("log", "--pretty=format:%h|%s|%ad",
                         "--date=short", "--no-merges", "-n", "5")


class SCMService:
    """generateCommitMessage over the local policy (or any PolicyClient)."""

    def __init__(self, client: PolicyClient):
        self.client = client

    def gather_context(self, repo: GitRepo) -> Tuple[str, str, str, str]:
        staged = repo.has_staged_changes()
        stat = repo.stat(staged)
        top = sorted(repo.numstat(staged), key=lambda fc: -fc[1])
        top = top[:MAX_DIFF_FILES]
        sampled = "\n\n".join(
            f"==== {file} ====\n{repo.sampled_diff(file, staged)}"
            for file, _count in top)
        try:
            log = repo.log()
        except RuntimeError:     # repo with no commits yet
            log = ""
        return stat, sampled, repo.branch(), log

    def generate_commit_message(self, repo_path: str, *,
                                temperature: float = 0.0) -> str:
        repo = GitRepo(repo_path)
        stat, sampled, branch, log = self.gather_context(repo)
        if not stat:
            raise RuntimeError("no changes to describe (clean tree)")
        resp = self.client.chat(
            [ChatMessage("system", COMMIT_MESSAGE_SYSTEM),
             ChatMessage("user", commit_message_user_prompt(
                 stat, sampled, branch, log))],
            temperature=temperature)
        message = extract_commit_message(resp.text)
        if not message:
            raise RuntimeError(
                "model response carried no <output> commit message")
        return message
