select i_item_id, ca_country, ca_state, ca_county,
    avg(cs_quantity) as agg1, avg(cs_list_price) as agg2,
    avg(cs_coupon_amt) as agg3, avg(cs_sales_price) as agg4,
    avg(cs_net_profit) as agg5, avg(c_birth_year) as agg6,
    avg(cd1.cd_dep_count) as agg7
from catalog_sales, customer_demographics cd1,
     customer_demographics cd2, customer, customer_address,
     date_dim, item
where cs_sold_date_sk = d_date_sk
    and cs_item_sk = i_item_sk
    and cs_cdemo_sk = cd1.cd_demo_sk
    and cs_customer_sk = c_customer_sk
    and cd1.cd_gender = 'F'
    and cd1.cd_education_status = 'Unknown'
    and c_current_cdemo_sk = cd2.cd_demo_sk
    and c_current_addr_sk = ca_address_sk
    and c_birth_month in (1, 6, 8, 9, 12, 2)
    and d_year = 1998
    and ca_state in ('MS', 'IN', 'ND', 'OK', 'NM', 'VA', 'MI')
group by rollup(i_item_id, ca_country, ca_state, ca_county)
order by ca_country nulls first, ca_state nulls first,
    ca_county nulls first, i_item_id nulls first
limit 100
