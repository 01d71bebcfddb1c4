"""Training reports: CSV and text summaries, and plots (matplotlib, imported where it is used)."""
