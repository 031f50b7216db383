"""PartnerMerge: the partner's (the municipality office's) prefecture and
address joined onto the products (port of the JAX package's
``preprocessing/partner.py``; a left join that keeps the products' order)."""

from __future__ import annotations

from .frame import Frame

__all__ = ["PartnerMerge"]


class PartnerMerge:
    def __init__(self, partner_df: Frame):
        self._partner_df = partner_df

    def transform(self, product_unique_df: Frame) -> Frame:
        return product_unique_df.merge_left(
            self._partner_df[["partner_id", "head_office_pref", "head_office_addr01"]], on="partner_id"
        )
