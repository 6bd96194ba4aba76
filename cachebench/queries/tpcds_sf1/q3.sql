select d_year, i_brand_id as brand_id, i_brand as brand,
    sum(ss_ext_sales_price) as sum_agg
from date_dim dt, store_sales, item
where dt.d_date_sk = store_sales.ss_sold_date_sk
    and store_sales.ss_item_sk = item.i_item_sk
    and item.i_manufact_id = 128
    and dt.d_moy = 11
group by d_year, i_brand_id, i_brand
order by d_year, sum_agg desc, brand_id
limit 100
